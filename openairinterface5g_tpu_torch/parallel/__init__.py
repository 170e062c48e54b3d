"""Multi-device programs over torch.distributed (port of
openairinterface5g_tpu/parallel/).

The JAX package maps the reference's process-level parallelism onto mesh
axes under ``shard_map``:
  dp — slots / Monte-Carlo trials / UEs (data parallel)
  cb — code blocks within a TB (the reference's per-CB thread jobs)
  sp — subcarrier blocks (fronthaul-split analog)
The port keeps the axis names, the function names, their arguments and
their return layouts, but every function is SPMD: each rank of a
``torch.distributed`` group (NCCL on the card, gloo only where the CPU is
asked for) calls it on its own shard.  ``launch.spawn`` gives
single-controller callers JAX's view: start N ranks, run one function,
return each rank's result.

Importing this package, or any of its modules, starts no process group.
"""
