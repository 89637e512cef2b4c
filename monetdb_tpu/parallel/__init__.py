"""Intra-query data parallelism over a jax.sharding.Mesh — the device-native
replacement for the reference's mitosis/mergetable/mat.pack pipeline
(monetdb5/optimizer/opt_mitosis.c, opt_mergetable.c, modules/mal/mat.c):
rows are hash/range-partitioned across chips, operators run as SPMD
shard_map programs, and the merge step is a collective (psum for partial
aggregates, all_gather only at result export)."""

from .mitosis import (shard_array, row_mesh, two_phase_sum,  # noqa: F401
                      sharded_q1, sharded_q6, default_mesh)
