"""Exact masked cosine top-k via XLA (`dot` + `lax.top_k`).

Replacement for the reference's NumPy GEMM + argpartition/argsort path
(picovdb/pico_vdb.py:670-714): one XLA program computing
`scores = Q @ V.T`, masking inactive / filtered-out rows to -inf, and
selecting top-k on device. On the GPU, XLA hands the dot to cuBLAS.

Every float32 dot whose scores are ranked or returned runs at
`Precision.HIGHEST`: a default-precision f32 dot may run in TF32 on the GPU,
which keeps about three decimal digits, and "exact" would no longer be.
bfloat16 and int8 selection keep their own dtypes (their winners are
rescored afterwards).

Bounded temporaries: the dense form materializes a (Q, rows) f32 score
matrix (and, for int4 storage, the unpacked (rows, dim) corpus). Callers
pass `block` (rows per step, see `scan_block`) when that would not fit the
store's temporary budget (DeviceIndex.temp_budget); the corpus is then walked in row blocks under
`lax.scan` with a running top-k merge, so no temporary exceeds one block.
Both forms select the same rows: a merge of per-block top-m sets is the
global top-m, and ties keep the lower row first in either form.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from ..utils import budget_block
from .quant import (
    HIGHEST,
    quantize_rows_i8,
    rescore_exact,
    rescore_exact_i4r,
    rescore_exact_i8r,
    unpack_i4,
)

NEG_INF = float("-inf")

# Smallest row block the blocked scan walks: below this the per-step merge
# dominates, and a budget that small means the store itself is at the limit.
MIN_SCAN_BLOCK = 1024


def normalize_on_device(q):
    """Zero-safe L2 normalization on device (zero rows -> e0).

    Device-side counterpart of utils.normalize_batch (reference query-side
    normalization: picovdb/pico_vdb.py:583-591); runs fused under jit so
    query batches never need a host normalization pass. Idempotent for
    already-normalized inputs.
    """
    norms = jnp.linalg.norm(q, axis=1, keepdims=True)
    zero = norms == 0.0
    col0 = jax.lax.broadcasted_iota(jnp.int32, q.shape, 1) == 0
    q = jnp.where(zero & col0, 1.0, q)
    norms = jnp.where(zero, 1.0, norms)
    return (q / norms).astype(jnp.float32)


def scan_bytes_per_row(num_q: int, route: str, dim: int) -> int:
    """Temporary device bytes per corpus row of one scan over `num_q`
    queries: the f32 score row and its masked copy, plus the int32 dot
    output on the quantized routes and the unpacked row for int4."""
    per = 8 * num_q
    if route in ("i8r", "i4r"):
        per += 4 * num_q
    if route == "i4r":
        per += dim
    return per


def scan_block(rows: int, num_q: int, route: str, dim: int,
               budget: Optional[int]) -> Optional[int]:
    """Rows per scan step so the temporaries fit `budget` bytes, or None
    for the dense form (it fits, or no bound is known). Blocks are powers
    of two, at least MIN_SCAN_BLOCK rows."""
    return budget_block(rows, scan_bytes_per_row(num_q, route, dim), budget,
                        MIN_SCAN_BLOCK)


def _dot(q, v, out_dtype=jnp.float32):
    """q (Q, d) x v (n, d)^T; HIGHEST when both operands are f32."""
    precision = HIGHEST if (q.dtype == jnp.float32
                            and v.dtype == jnp.float32) else None
    return jax.lax.dot_general(
        q, v, dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=out_dtype, precision=precision,
    )


def blocked_topk(score_rows, mask, k: int, block: Optional[int], num_q: int):
    """Masked top-k over all rows of the corpus.

    `score_rows(start, n)` returns the (Q, n) f32 scores of rows
    [start, start + n). With `block=None` it is called once over every
    row (the dense form). Otherwise the rows are walked `block` at a time
    under `lax.scan`; the last block is slid back to end at the last row
    and its rows already covered are masked off, so any row count works.
    """
    rows = mask.shape[0]
    k = min(k, rows)
    if block is None or block >= rows:
        scores = jnp.where(mask[None, :], score_rows(0, rows), NEG_INF)
        vals, idx = jax.lax.top_k(scores, k)
        return vals, idx.astype(jnp.int32)
    n_blocks = -(-rows // block)
    k_blk = min(k, block)

    def block_topk(b):
        nominal = b * block
        start = jnp.minimum(nominal, rows - block)
        row = start + jax.lax.broadcasted_iota(jnp.int32, (1, block), 1)
        live = jax.lax.dynamic_slice_in_dim(mask, start, block)[None, :]
        live = live & (row >= nominal)
        s = jnp.where(live, score_rows(start, block), NEG_INF)
        bv, bi = jax.lax.top_k(s, k_blk)
        return bv, bi.astype(jnp.int32) + start

    def step(carry, b):
        bv, bi = block_topk(b)
        cat_v = jnp.concatenate([carry[0], bv], axis=1)
        cat_i = jnp.concatenate([carry[1], bi], axis=1)
        v, order = jax.lax.top_k(cat_v, k)
        return (v, jnp.take_along_axis(cat_i, order, axis=1)), None

    # The first block seeds the carry (padded to k with -inf), so the
    # carry has the types of the scores, also inside shard_map bodies.
    vals, idx = block_topk(0)
    if k_blk < k:
        pad = ((0, 0), (0, k - k_blk))
        vals = jnp.pad(vals, pad, constant_values=NEG_INF)
        idx = jnp.pad(idx, pad)
    (vals, idx), _ = jax.lax.scan(
        step, (vals, idx), jnp.arange(1, n_blocks, dtype=jnp.int32)
    )
    return vals, idx


def exact_topk(queries, vectors, mask, k: int, compute_dtype=None,
               block: Optional[int] = None):
    """Masked exact top-k.

    Args:
      queries: (Q, dim) normalized query batch.
      vectors: (cap, dim) normalized corpus (padded rows are masked off).
      mask: (cap,) bool — active AND filter mask.
      k: static number of results per query (k <= cap).
      compute_dtype: optional dtype for the GEMM inputs (e.g. bfloat16);
        accumulation stays float32.
      block: rows per scan step (None = dense, see `scan_block`).

    Returns:
      (values, indices): (Q, k) float32 scores and (Q, k) int32 slot indices.
      Masked-off rows never surface unless fewer than k candidates exist, in
      which case padding entries carry -inf scores (host assembly drops them).
    """
    q = queries if compute_dtype is None else queries.astype(compute_dtype)

    def score_rows(start, n):
        v = jax.lax.dynamic_slice_in_dim(vectors, start, n)
        if compute_dtype is not None:
            v = v.astype(compute_dtype)
        return _dot(q, v)

    return blocked_topk(score_rows, mask, k, block, queries.shape[0])


def approx_topk_rescored(queries, vectors, mask, k: int, k_sel: int,
                         recall_target: float = 0.95, compute_dtype=None):
    """Masked top-k via `lax.approx_max_k` over the (Q, cap) score matrix,
    with exact f32 rescoring of the k_sel candidates.

    The recall target bounds what selection may miss (backends without an
    approximate top-k select exactly, matching the exact route). Callers
    chunk Q so the score matrix fits.
    """
    if compute_dtype is not None:
        q = queries.astype(compute_dtype)
        v = vectors.astype(compute_dtype)
    else:
        q, v = queries, vectors
    scores = jnp.where(mask[None, :], _dot(q, v), NEG_INF)
    k_sel = min(k_sel, scores.shape[1])
    vals, idx = jax.lax.approx_max_k(scores, k_sel,
                                     recall_target=recall_target)
    vals, idx = rescore_exact(queries, vectors, vals, idx)
    return vals[:, :k], idx[:, :k].astype(jnp.int32)


@functools.lru_cache(maxsize=256)
def make_approx_topk(k: int, compute_dtype_name: str | None = None,
                     normalize: bool = True, recall_target: float = 0.95):
    """Jitted approx-then-rescore top-k closure (k_sel = 2k guard)."""
    compute_dtype = jnp.dtype(compute_dtype_name) if compute_dtype_name else None
    k_sel = max(2 * k, k + 16)

    def fn(queries, vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        return approx_topk_rescored(
            queries, vectors, mask, k, k_sel, recall_target, compute_dtype
        )

    return jax.jit(fn)


def _quant_topk(queries, vq, vscale, mask, k, guard, block, unpack, rescore):
    """Shared body of the int8 / int4 storage routes: int8 x int8 -> int32
    selection with per-row rescale (the query's own quantization scale is
    a positive per-query constant, so ranking is unchanged), top-(k+guard),
    then the dequantizing rescore of the winners."""
    q_i8, _ = quantize_rows_i8(queries)

    def score_rows(start, n):
        v = jax.lax.dynamic_slice_in_dim(vq, start, n)
        if unpack:
            v = unpack_i4(v)
        s = _dot(q_i8, v, jnp.int32).astype(jnp.float32)
        return s * jax.lax.dynamic_slice_in_dim(vscale, start, n)[None, :]

    vals, idx = blocked_topk(score_rows, mask, k + guard, block,
                             queries.shape[0])
    vals, idx = rescore(queries, vq, vscale, vals, idx)
    return vals[:, :k], idx[:, :k].astype(jnp.int32)


def exact_topk_i8r(queries, v_i8, vscale, mask, k: int, guard: int = 4,
                   block: Optional[int] = None):
    """Masked top-k over a per-ROW-quantized int8 corpus (storage tier).

    Scores carry the storage quantization (~3e-4 absolute at dim 1024);
    the engine's host rescore restores exact f32 ranking on host-born
    stores."""
    return _quant_topk(queries, v_i8, vscale, mask, k, guard, block,
                       unpack=False, rescore=rescore_exact_i8r)


def exact_topk_i4r(queries, v_i4, vscale, mask, k: int, guard: int = 4,
                   block: Optional[int] = None):
    """Masked top-k over a packed int4 corpus (storage tier): the int8
    route with each row block unpacked from its two nibble planes first.
    Scores carry the 4-bit storage quantization."""
    return _quant_topk(queries, v_i4, vscale, mask, k, guard, block,
                       unpack=True, rescore=rescore_exact_i4r)


@functools.lru_cache(maxsize=256)
def make_exact_topk_i8r(k: int, normalize: bool = True,
                        block: Optional[int] = None):
    """Jitted `exact_topk_i8r` closure for a static k."""

    def fn(queries, v_i8, vscale, mask):
        if normalize:
            queries = normalize_on_device(queries)
        return exact_topk_i8r(queries, v_i8, vscale, mask, k, block=block)

    return jax.jit(fn)


@functools.lru_cache(maxsize=256)
def make_exact_topk_i4r(k: int, normalize: bool = True,
                        block: Optional[int] = None):
    """Jitted `exact_topk_i4r` closure for a static k."""

    def fn(queries, v_i4, vscale, mask):
        if normalize:
            queries = normalize_on_device(queries)
        return exact_topk_i4r(queries, v_i4, vscale, mask, k, block=block)

    return jax.jit(fn)


@functools.lru_cache(maxsize=256)
def make_exact_topk(k: int, compute_dtype_name: str | None = None,
                    normalize: bool = True, block: Optional[int] = None):
    """Build a jitted exact-top-k closure for a static k / compute dtype.

    Queries are L2-normalized on device by default (idempotent for
    pre-normalized inputs). Device placement follows the (committed) input
    arrays, so the same closure serves CPU tests and the GPU.
    """
    compute_dtype = jnp.dtype(compute_dtype_name) if compute_dtype_name else None

    def fn(queries, vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        return exact_topk(queries, vectors, mask, k, compute_dtype, block)

    return jax.jit(fn)
