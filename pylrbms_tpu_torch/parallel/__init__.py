"""Distribution of the subdomain axis over ranks (``torch.distributed``).

The port of ``pylrbms_tpu/parallel``: one process per rank, each holding a
contiguous band of the K subdomains on its device, with the collectives
that XLA inserts under GSPMD (or that ``shard_map`` spells out) written
out: halo rows by point-to-point exchange, dot products by ``all_reduce``
and replicated results by ``all_gather``.  :mod:`.mesh` holds the mesh and
the K-sharded solves, :mod:`.stencil` the banded operators with their halo
apply, :mod:`.spmd` the hand-written row-sharded online solve.
"""
