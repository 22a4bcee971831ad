"""Quantized storage formats and the rescore helpers that read them.

Plain `jax.numpy` code shared by the exact routes (ops/exact.py), the IVF
tier (ops/ivf.py, parallel/ivf_mesh.py) and the device store
(device.py):

  * per-row int8: `quantize_rows_i8`, dequantizing rescore
    `rescore_exact_i8r`;
  * per-row int4, two nibbles per byte: `quantize_rows_i4`, `unpack_i4`
    (device) / `unpack_i4_np_into` (host), rescore `rescore_exact_i4r`;
  * per-column int8 (IVF postings): `quantize_cols_i8`,
    `quantize_cols_scaled_i8`, `colmax_abs`, `fold_queries_i8`;
  * the float rescore `rescore_exact`.

Every float32 dot here runs at `Precision.HIGHEST`: its scores are the ones
returned to callers, and a default-precision f32 dot may run in TF32 on
the GPU (about three decimal digits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

HIGHEST = jax.lax.Precision.HIGHEST


def _sort_desc(exact, vals, idxs):
    """Re-rank candidates by exact score, keeping -inf padding markers."""
    exact = jnp.where(jnp.isneginf(vals), -jnp.inf, exact)
    order = jnp.argsort(-exact, axis=1)
    return jnp.take_along_axis(exact, order, axis=1), jnp.take_along_axis(
        idxs, order, axis=1
    )


def rescore_exact(queries, vectors, vals, idxs):
    """Replace selection scores with exact f32 dot products.

    Gathers the winning rows per query, recomputes q.v in float32
    (HIGHEST: these are the returned scores), keeps -inf padding markers
    and re-sorts by the exact scores.
    """
    gathered = jnp.take(vectors, idxs, axis=0).astype(jnp.float32)
    exact = jnp.einsum(
        "qd,qkd->qk", queries, gathered,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    )
    return _sort_desc(exact, vals, idxs)


def rescore_exact_i8r(queries, v_i8, vscale, vals, idxs):
    """Dequantizing rescore against a per-row int8 STORAGE corpus.

    The winning rows are reconstructed as v = v_i8 * vscale[row]; returned
    scores carry the storage quantization (~vscale/2 per element)."""
    gathered = jnp.take(v_i8, idxs, axis=0).astype(jnp.float32)
    exact = jnp.einsum(
        "qd,qkd->qk", queries, gathered,
        preferred_element_type=jnp.float32, precision=HIGHEST,
    ) * jnp.take(vscale, idxs)
    return _sort_desc(exact, vals, idxs)


@jax.jit
def quantize_rows_i8(v):
    """Per-row symmetric int8 quantization: (rows int8, scales f32).

    scales[r] = max|v[r]| / 127 (floored to avoid div-by-zero on deleted
    all-zero rows, which quantize to 0 and are masked off anyway)."""
    f = v.astype(jnp.float32)
    a = jnp.max(jnp.abs(f), axis=1)
    s = jnp.maximum(a, 1e-30) / 127.0
    q = jnp.round(f / s[:, None])
    return jnp.clip(q, -127, 127).astype(jnp.int8), s


@jax.jit
def quantize_rows_i4(v):
    """Per-row symmetric int4 quantization: (packed int8 (n, dim//2),
    scales f32 (n,)).

    scales[r] = max|v[r]| / 7 (floored like `quantize_rows_i8`); nibble
    values are clip(round(v/s), -7, 7) + 8, both nibbles biased unsigned
    [1, 15]. Element j sits in the LOW nibble of byte j, element j+dim/2
    in the HIGH nibble. `dim` must be even.
    """
    f = v.astype(jnp.float32)
    half = f.shape[1] // 2
    a = jnp.max(jnp.abs(f), axis=1)
    s = jnp.maximum(a, 1e-30) / 7.0
    q = jnp.clip(jnp.round(f / s[:, None]), -7, 7).astype(jnp.int32) + 8
    lo = q[:, :half]
    hi = q[:, half:]
    # int32 -> int8 conversion truncates bits (XLA modular semantics), so
    # the packed byte keeps both nibbles intact.
    return (lo | (hi << 4)).astype(jnp.int8), s


def unpack_i4(packed):
    """(..., dim//2) packed int8 -> (..., dim) int8 nibble values in
    [-7, 7] (inverts `quantize_rows_i4`; multiply by the per-row scales
    to dequantize). The single home of the nibble-layout contract."""
    p = packed.astype(jnp.int32) & 255
    lo = (p & 15) - 8
    hi = ((p >> 4) & 15) - 8
    return jnp.concatenate([lo, hi], axis=-1).astype(jnp.int8)


def unpack_i4_np_into(packed: np.ndarray, out: np.ndarray) -> None:
    """NumPy twin of `unpack_i4` for host-side paths, writing UNSCALED
    nibble values into a caller-provided (n, dim) buffer (no (n, dim)
    integer temp, so chunked host materialization bounds its transients)."""
    half = packed.shape[1]
    p = packed.astype(np.int16) & 255
    out[:, :half] = (p & 15) - 8
    out[:, half:] = ((p >> 4) & 15) - 8


def rescore_exact_i4r(queries, v_i4, vscale, vals, idxs):
    """Dequantizing rescore against a packed int4 STORAGE corpus: the
    winning rows unpack to [-7, 7] and reconstruct as nibble * vscale[row]
    (returned scores carry the 4-bit storage quantization; the engine's
    host rescore restores exact ranking on host-born stores)."""
    g = jnp.take(v_i4, idxs, axis=0).astype(jnp.int32) & 255
    lo = ((g & 15) - 8).astype(jnp.float32)
    hi = (((g >> 4) & 15) - 8).astype(jnp.float32)
    half = v_i4.shape[1]
    exact = (
        jnp.einsum("qd,qkd->qk", queries[:, :half], lo,
                   preferred_element_type=jnp.float32, precision=HIGHEST)
        + jnp.einsum("qd,qkd->qk", queries[:, half:], hi,
                     preferred_element_type=jnp.float32, precision=HIGHEST)
    ) * jnp.take(vscale, idxs)
    return _sort_desc(exact, vals, idxs)


@jax.jit
def quantize_cols_i8(v):
    """Per-column symmetric int8 quantization: (rows int8, col scales f32).

    scales[d] = max_r |v[r, d]| / 127 (floored to avoid div-by-zero on
    all-zero columns, which quantize to 0)."""
    f = v.astype(jnp.float32)
    a = jnp.max(jnp.abs(f), axis=0)
    s = jnp.maximum(a, 1e-30) / 127.0
    q = jnp.round(f / s[None, :])
    return jnp.clip(q, -127, 127).astype(jnp.int8), s


@jax.jit
def quantize_cols_scaled_i8(v, s):
    """Column-quantize with PRE-COMPUTED scales (chunked-build path: a
    first pass reduces the per-column abs-max, then each chunk quantizes
    against the shared scales here)."""
    q = jnp.round(v.astype(jnp.float32) / s[None, :])
    return jnp.clip(q, -127, 127).astype(jnp.int8)


@jax.jit
def colmax_abs(v):
    """Per-column abs-max (f32), the reduction half of the chunked
    column quantization."""
    return jnp.max(jnp.abs(v.astype(jnp.float32)), axis=0)


@jax.jit
def fold_queries_i8(queries, cscale):
    """Fold the corpus column scales into queries, then int8-quantize.

    The per-query quantization scale is a positive constant and cannot
    change that query's ranking, so it is dropped."""
    q, _ = quantize_rows_i8(queries.astype(jnp.float32) * cscale[None, :])
    return q


def selection_noise(kind: str, dim: int) -> float:
    """Score-noise scale of a quantized storage tier at this dim.

    rms * sqrt(dim) per kind, measured bias-removed against a float64
    oracle (bf16 4.2e-4 at dim 16 -> 5.2e-5 at dim 1024; int8 2.2e-3 ->
    3.8e-4); int4's step is 127/7 ~ 18x int8's. The engine's host rescore
    uses it to detect a guard band that may be truncated mid-tie."""
    base = {"bf16": 0.0017, "int4": 0.22}.get(kind, 0.0122)
    return base / (dim ** 0.5)
