"""parallel layer of vectorx_tpu_torch.

- ``mesh``       — ``Mesh`` (an ordered list of torch devices, repeats
                   allowed), ``make_mesh``, ``shard_batch``, ``replicate``
- ``ntt_dist``   — the four-step NTT with its columns over a mesh and
                   ``ShardedNttOps``, the prover's NTT seam
- ``subchain``   — the header-subchain check, on one device or with the
                   header axis sharded over a mesh
- ``multihost``  — processes on torch.distributed (gloo, NCCL): the
                   two-tier ``dcn_mesh``, ``shard_headers``
- ``dcn_demo``   — the two-process demo (``python -m``)
- ``dryrun``     — ``dryrun_multichip``: subchain, NTT and prove on a mesh
- ``map_prove``, ``map_worker``, ``aggregate`` — proofs over devices and
                   worker processes, and their reduce
"""
