"""Distributed layer: device meshes, shard_map query, cross-device top-k merge.

The reference is single-process shared-memory only (SURVEY.md §2: its only
parallelism is FAISS's OpenMP, picovdb/pico_vdb.py:177-191). Here the corpus
rows are sharded across a `jax.sharding.Mesh`; each shard computes a local
top-k and the (k x shards) candidates are merged by an allgather that XLA
hands to the collective library (NCCL on GPUs) — a step the reference never
had.
"""

from .mesh import make_mesh, default_mesh  # noqa: F401
from .sharded_query import make_sharded_topk  # noqa: F401
