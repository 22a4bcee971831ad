"""Row-sharded exact query with a cross-device top-k merge.

Each corpus shard computes a local masked top-k (ops/exact.py, f32 dots at
HIGHEST precision); the per-shard (score, global-index) candidate slabs — k
entries per shard — are laid out along a sharded axis and merged by a final
small top-k, which XLA lowers to an allgather of (Q, k*shards) over the
device interconnect followed by on-device selection. This
replaces the reference's single-process result assembly
(picovdb/pico_vdb.py:752-775) at multi-chip scale.

The optional `dp` mesh axis additionally shards the *query batch*, so the
merge collective stays intra-`shard`-axis and query throughput scales with
both axes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

try:  # JAX >= 0.6 exposes shard_map at top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover - older JAX
    from jax.experimental.shard_map import shard_map as _shard_map

from ..ops.exact import exact_topk, exact_topk_i4r, exact_topk_i8r

# Bounded build cache. The key includes id(mesh), and the cached jitted
# fns close over the mesh object — an UNbounded dict would therefore pin
# every mesh ever queried (plus its compiled executables) for the process
# lifetime; a long-lived process that recreates meshes leaks until OOM
# (observed: a 43 x 10-config fuzz soak exhausted host memory through
# exactly this path). FIFO eviction drops the oldest builds; a re-query
# against an evicted (mesh, k, ...) combination just recompiles.
_CACHE = {}
_CACHE_MAX = 64


def make_sharded_topk(mesh, shard_axis: str, k: int, compute_dtype_name=None,
                      dp_axis: str = "dp", normalize: bool = True,
                      storage_i8: bool = False, storage_i4: bool = False,
                      block=None):
    """Build a jitted sharded masked-top-k for a static k.

    Signature of the returned fn: (queries (Q, dim) [dp-sharded if dp>1],
    vectors (cap, dim) row-sharded, mask (cap,) row-sharded) ->
    (values (Q, k) f32, indices (Q, k) int32 global slot ids).

    `storage_i8=True` serves an int8 STORAGE corpus (per-row-quantized
    rows + scales, see DeviceIndex): the returned fn takes an extra
    `vscale (cap,) f32` row-sharded argument after `vectors`, each shard
    selects over its int8 rows and rescores the winners dequantized, so
    the merged scores carry storage precision exactly like the
    single-device int8 route.

    `storage_i4=True` serves a packed int4 STORAGE corpus (two nibbles per
    byte, (cap, dim//2) int8 + per-row scales): same extra `vscale`
    argument and the same select-then-dequantizing-rescore shape as int8.
    Merged scores carry 4-bit storage precision; host-born stores restore
    exact ranking via the engine's host-f64 rescore tier exactly as on a
    single device.

    `block` bounds each shard's temporaries like the single-device routes
    (ops/exact.scan_block over the shard's rows).
    """
    key = (id(mesh), mesh.shape_tuple, shard_axis, k, compute_dtype_name,
           dp_axis, normalize, storage_i8, storage_i4, block)
    fn = _CACHE.get(key)
    if fn is None:
        fn = _build(mesh, shard_axis, k, compute_dtype_name, dp_axis,
                    normalize, storage_i8, storage_i4, block)
        while len(_CACHE) >= _CACHE_MAX:
            _CACHE.pop(next(iter(_CACHE)), None)
        _CACHE[key] = fn
    return fn


def _build(mesh, shard_axis, k, compute_dtype_name, dp_axis, normalize,
           storage_i8=False, storage_i4=False, block=None):
    compute_dtype = jnp.dtype(compute_dtype_name) if compute_dtype_name else None
    has_dp = dp_axis in mesh.shape and mesh.shape[dp_axis] > 1
    q_spec = P(dp_axis, None) if has_dp else P()
    out_q = dp_axis if has_dp else None

    def local(q, v, m):
        rows_local = v.shape[0]
        vals, idx = exact_topk(q, v, m, min(k, rows_local), compute_dtype,
                               block)
        base = (jax.lax.axis_index(shard_axis) * rows_local).astype(jnp.int32)
        return vals, idx + base

    def local_quant(q, vq, vs, m):
        # int8/int4 STORAGE body: selection over the quantized rows with a
        # +4 guard, winners dequant-rescored before the slice
        rows_local = vq.shape[0]
        exact = exact_topk_i4r if storage_i4 else exact_topk_i8r
        vals, idx = exact(q, vq, vs, m, min(k, rows_local), block=block)
        base = (jax.lax.axis_index(shard_axis) * rows_local).astype(jnp.int32)
        return vals, idx + base

    if storage_i8 or storage_i4:
        in_specs = (q_spec, P(shard_axis, None), P(shard_axis),
                    P(shard_axis))
        body = local_quant
    else:
        in_specs = (q_spec, P(shard_axis, None), P(shard_axis))
        body = local
    mapped = _shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(out_q, shard_axis), P(out_q, shard_axis)),
    )

    def merged(q, *arrays):
        if normalize:
            from ..ops.exact import normalize_on_device

            q = normalize_on_device(q)
        vals, idx = mapped(q, *arrays)  # (Q, shards * k_local)
        k_final = min(k, vals.shape[1])
        top_vals, order = jax.lax.top_k(vals, k_final)
        top_idx = jnp.take_along_axis(idx, order, axis=1)
        return top_vals, top_idx

    return jax.jit(merged)
