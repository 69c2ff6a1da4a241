"""Per-layer metric verify_kernels_per_job.shards: verify_kernels_per_job
in the cells that read the verify per layer (verify_s.shards), where it
moves prove_s."""

from vxbench.metrics.verify_kernels_per_job import read  # noqa: F401
