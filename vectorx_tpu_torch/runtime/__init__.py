"""host runtime of vectorx_tpu_torch (see the package docstring)."""
