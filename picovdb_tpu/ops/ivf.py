"""IVF-flat ANN tier: device k-means + hot-tile probe scan.

Device replacement for the reference's FAISS HNSW acceleration tier
(picovdb/pico_vdb.py:171-212, 866-921) for corpora where even the exact
scan's full sweep of device memory is too slow. Design:

  * **Train**: spherical k-means runs on device (Lloyd iterations under
    jit, cosine assignment as one matrix product, segment-sum centroid
    updates).
  * **Layout**: corpus rows are reordered cluster-contiguous into an IVF
    mirror (`vectors` (cap_ivf, dim) padded to the `IVF_BN`-row tile size,
    plus `slots` mapping IVF rows back to engine slot ids).
  * **Search**: queries score centroids, take the top `nprobe` clusters
    each, and the union of probed clusters over the batch becomes a *hot
    tile list*. The probe gathers those tiles, masks rows whose cluster
    was not probed, scores them in one dot and keeps the top candidates;
    cold tiles are never read. An exact rescore and slot translation
    follow.

The union-over-batch semantics only ever *adds* candidates relative to
per-query probing, so recall is >= classic IVF at equal nprobe; the bytes
read are proportional to the number of distinct probed clusters in the
batch.

`ef_search`-style knobs map to nprobe (see `ef_to_nprobe`), preserving the
reference's "higher ef = more accurate" contract (picovdb/pico_vdb.py:719-729).
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import Float
from ..utils import budget_block, next_pow2, round_up, scatter_floor
from .quant import (
    colmax_abs,
    fold_queries_i8,
    quantize_cols_i8,
    quantize_cols_scaled_i8,
    rescore_exact,
    unpack_i4,
)

# Tile size of the IVF mirror: the unit of the hot-tile list. Larger tiles
# mean fewer gather steps but coarser skipping (a probed cluster of
# ~sqrt(N)/2 rows spans ~size/IVF_BN + 1 tiles, so bigger tiles read more
# cold rows). Policy kept from the first platform; to calibrate on the
# H100. PICOVDB_IVF_BN overrides (layout-coupled: takes effect at the next
# build).
IVF_BN = int(os.getenv("PICOVDB_IVF_BN", "1024") or 1024)


# int8 postings selection noise is ~0.3 * max_col_scale absolute, which
# shrinks as 1/sqrt(dim) for L2-normalized rows; below this dim the noise
# rivals real score gaps on clustered data (exact-probe top-1 misses at
# dim=16) and the storage-dtype sweep serves instead.
IVF_I8_MIN_DIM = 256


def _ivf_i8_enabled(dim: int) -> bool:
    """Whether int8 postings may serve the probe scan (PICOVDB_IVF_I8).

    Selection ranks raw int32 scores of the 1 B/element column-scaled
    postings (scales folded into the query) inside a widened guard band;
    ranking is exact-rescored against the storage-dtype rows as always.
    Default: allowed for dim >= IVF_I8_MIN_DIM; PICOVDB_IVF_I8=0 opts out,
    =1 forces it at any dim."""
    env = os.getenv("PICOVDB_IVF_I8", "auto").strip().lower()
    if env in ("auto", ""):
        return dim >= IVF_I8_MIN_DIM
    # only explicit truthy values force-enable below the dim floor —
    # 'off'/'no'/typos must not read as opt-in (same parser contract as
    # `_ivf_i8_mirror`; the low-dim regime has measured top-1 misses)
    return env in ("1", "true", "on", "yes")


def _ivf_guard(is_i8: bool, dim: int) -> int:
    """Selection guard width beyond k (PICOVDB_IVF_GUARD overrides).

    The probe selects k+guard candidates, then exact-rescores; winners
    the low-precision selection drops below the band are unrecoverable.
    bf16/f32 postings: +4 (selection is near-exact). int8-family
    selection (postings mirror / int8-only layout): +22 at
    dim >= IVF_I8_MIN_DIM, where a +6 band shed ~2% of the true top-10 to
    int8 selection noise on a clustered 4M x 1024 corpus; +6 below it.
    Policy kept from the first platform; to calibrate on the H100."""
    env = os.getenv("PICOVDB_IVF_GUARD")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    if not is_i8:
        return 4
    return 22 if dim >= IVF_I8_MIN_DIM else 6


def _ivf_i8_mirror(dim: int) -> bool:
    """Optional classic-layout int8 postings mirror — OPT-IN (PICOVDB_IVF_I8=1).

    On a clustered 2M x 1024 corpus int8 selection noise inside the k+6
    guard cost ~1.4% recall@10 next to bf16 postings, and the mirror
    spends cap_ivf*dim extra device bytes, so it is off by default. int8
    STORAGE and the int8-only layout still use int8 postings out of
    necessity (capability-gated by `_ivf_i8_enabled`)."""
    env = os.getenv("PICOVDB_IVF_I8", "auto")
    # only explicit truthy values opt in — 'off'/'no'/typos must not
    # silently enable the mirror (review finding, fifth session)
    if env.lower() in ("1", "true", "on", "yes"):
        return _ivf_i8_enabled(dim)
    return False


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_rows_ivf(arr, idx, vals):
    return arr.at[idx].set(vals.astype(arr.dtype))


@jax.jit
def _gather_rows(arr, idx):
    return jnp.take(arr, idx, axis=0)


@jax.jit
def _gather_rows_dequant(arr, scale, idx):
    """Gather + per-row dequantization (int8 STORAGE corpora): rows are
    reconstructed as v_i8 * vscale[row] so k-means, column quantization
    and rescore all see true-scale vectors."""
    rows = jnp.take(arr, idx, axis=0).astype(jnp.float32)
    return rows * jnp.take(scale, idx)[:, None]


@jax.jit
def _gather_rows_dequant_i4(arr, scale, idx):
    """`_gather_rows_dequant` for packed int4 STORAGE: gather the packed
    (cap, dim//2) byte rows, unpack both nibble planes (element j in the
    LOW nibble of byte j, j+dim/2 in the HIGH — quantize_rows_i4's
    layout), and reconstruct as nibble * vscale[row]."""
    full = unpack_i4(jnp.take(arr, idx, axis=0)).astype(jnp.float32)
    return full * jnp.take(scale, idx)[:, None]


@functools.partial(jax.jit, static_argnums=(2,), donate_argnums=(0,))
def _reorder_pad(vecs, order, cap_ivf: int):
    """Cluster-contiguous reorder + tile padding, entirely on device.

    Donates the gathered active-row buffer, so building the IVF mirror from
    the engine's HBM-resident corpus never round-trips vector data through
    the host (the r1 build paid two full host<->HBM corpus transfers)."""
    out = jnp.zeros((cap_ivf, vecs.shape[1]), vecs.dtype)
    return out.at[: order.shape[0]].set(jnp.take(vecs, order, axis=0))


@functools.partial(jax.jit, static_argnums=(2,))
def _reorder_pad_shared(vecs, order, cap_ivf: int):
    """Like `_reorder_pad` but for a source the caller keeps (the engine's
    live corpus mirror) — no donation."""
    out = jnp.zeros((cap_ivf, vecs.shape[1]), vecs.dtype)
    return out.at[: order.shape[0]].set(jnp.take(vecs, order, axis=0))


def _pad_pow2(arr: np.ndarray, min_bucket: int = 8) -> np.ndarray:
    """Pad a host scatter operand to a power-of-two bucket along axis 0 by
    repeating the LAST entry (duplicate scatter indices carry identical
    values — idempotent), so every epoch size inside a bucket reuses one
    compiled executable instead of keying its own 0.5-5 s XLA compile."""
    n = arr.shape[0]
    bucket = max(min_bucket, next_pow2(n))
    if bucket == n:
        return arr
    reps = np.repeat(arr[-1:], bucket - n, axis=0)
    return np.concatenate([arr, reps], axis=0)


def _np_scalar(value, dtype):
    """Scalar normalized to a non-weak numpy scalar so every call site
    (True/False deactivate/activate, cluster ids, warm identity writes)
    shares one jit executable per array shape — Python ints/bools trace
    as weakly-typed and would key separate compilations."""
    return np.asarray(value, dtype=dtype)[()]


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_set(arr, idx, value):
    # `value` is a traced scalar (not static): True/False writes and the
    # row_cluster overflow id all share ONE executable per (arr, idx)
    # shape, so the first dirty epoch compiles each scatter exactly once
    # and the build-time warm pass (warm_update_path) covers them all.
    return arr.at[idx].set(jnp.asarray(value, dtype=arr.dtype))


@functools.partial(jax.jit, donate_argnums=(0,))
def _set_tile_cells(c2t, tiles, cluster, value):
    """Write `value` into c2t[cluster, tiles] (all operands traced: the
    mutation path's hot-mark 1.0 and the warm pass's identity write share
    one executable)."""
    return c2t.at[jnp.asarray(cluster, jnp.int32), tiles].set(
        jnp.asarray(value, c2t.dtype)
    )


def default_nlist(n_active: int) -> int:
    """~2*sqrt(N), clamped — the usual IVF sizing rule."""
    return int(max(8, min(4096, 2 * math.sqrt(max(1, n_active)))))


def _i8_clip_max() -> float:
    """Max fraction of components the int8-only requantize-on-append may
    clip before `update` refuses and the engine falls back to a full
    rebuild (fresh scales). Default 0.05 — in-distribution appends clip
    ~0 (new rows share the build corpus' dynamic range); a higher rate
    means the data drifted and selection scores for the appended rows
    would bias low. Shared by the single-device and mesh i8-only tiers;
    override with PICOVDB_IVF_I8_CLIP_MAX."""
    try:
        return float(os.getenv("PICOVDB_IVF_I8_CLIP_MAX", "0.05"))
    except ValueError:
        return 0.05


def ef_to_nprobe(ef: int, nlist: int) -> int:
    """Map the reference's efSearch-style knob onto nprobe.

    efSearch defaults to 32 (reference: picovdb/pico_vdb.py:29); probing
    ef/2 clusters of a 2*sqrt(N)-list index scans ~ef/2 * sqrt(N)/2 rows,
    which tracks HNSW's visited-node count closely enough for the knob to
    keep its meaning ("higher = more accurate, slower").
    """
    return int(max(1, min(nlist, round(ef / 2))))


def should_build(n_active: int, dim: Optional[int] = None,
                 itemsize: float = 4.0) -> bool:
    """auto-index policy: build the tier once the exact sweep reads enough
    bytes that the probe's fixed overhead pays off.

    The exact sweep costs ~corpus_bytes / memory bandwidth; the probe has
    a fixed preamble (centroid scoring, hot-tile list). Threshold: >= 2 GiB
    of scanned bytes (1M x 1024 f32 / 2M bf16), a policy kept from the
    first platform; to calibrate on the H100. Row-count fallback when the
    caller can't say."""
    if dim:
        return n_active * dim * itemsize >= 2 * 2**30
    return n_active >= 2_000_000


@functools.partial(jax.jit, static_argnames=("nlist", "iters"))
def _kmeans(vectors, mask, init, nlist: int, iters: int):
    """Spherical k-means (cosine) over masked rows. Returns unit centroids."""

    def step(c, _):
        scores = vectors @ c.T  # (n, nlist)
        assign = jnp.argmax(scores, axis=1)
        w = mask.astype(jnp.float32)
        sums = jax.ops.segment_sum(
            vectors * w[:, None], assign, num_segments=nlist
        )
        norms = jnp.linalg.norm(sums, axis=1, keepdims=True)
        newc = jnp.where(norms > 1e-6, sums / jnp.maximum(norms, 1e-9), c)
        return newc, None

    c, _ = jax.lax.scan(step, init, None, length=iters)
    return c


def _assign(vectors, centroids):
    return jnp.argmax(vectors @ centroids.T, axis=1)


class IVFIndex:
    """Cluster-reordered device mirror + block-skipping search."""

    def __init__(self, centroids, vectors, slots, row_cluster, active,
                 cluster2tile, nlist: int, n_tiles: int, dim: int,
                 seg_starts=None) -> None:
        self.centroids = centroids  # (nlist_pad, dim) device f32
        self.vectors = vectors  # (cap_ivf, dim) device, storage dtype
        self.slots = slots  # (cap_ivf,) device int32, -1 pad
        self.row_cluster = row_cluster  # (cap_ivf,) device int32
        self.active = active  # (cap_ivf,) device bool
        self.cluster2tile = cluster2tile  # (nlist_pad, n_tiles) device f32 0/1
        # (nlist+2,) device int32: seg_starts[c] = first row of cluster c in
        # the cluster-contiguous layout; [nlist] = overflow/pad region start,
        # [nlist+1] = cap_ivf. Lets the per-query row mask be built as a
        # segment-boundary scatter + cumsum instead of a (cap_ivf,)-sized
        # table gather.
        self.seg_starts = seg_starts
        self.nlist = nlist
        self.n_tiles = n_tiles
        self.dim = dim
        self._host_blob: Optional[dict] = None
        # optional column-scaled int8 postings mirror (see _ivf_i8_enabled);
        # derived data — rebuilt from `vectors`, never persisted. In
        # int8-only mode (`vectors is None`) the mirror IS the postings
        # store and the exact rescore gathers rows from the engine's
        # corpus mirror by slot id instead (see `search_async`).
        self.vectors_i8c = None
        self.cscale = None
        # int8-only layout: frozen build-time column scales (host mirror)
        # for requantize-on-append, + clip-guard observability
        self._cscale_np: Optional[np.ndarray] = None
        self.last_update_clip_fraction: Optional[float] = None
        if vectors is not None and _ivf_i8_mirror(dim):
            self.refresh_i8_mirror()

    def refresh_i8_mirror(self) -> None:
        """(Re)derive the int8 postings mirror from the live IVF mirror.

        One on-device pass. The column scales are frozen host-side for
        `update()`'s O(changed) maintenance: appended rows requantize
        against them under the same clip-fraction guard as the i8-only
        layout, and only a guard trip (drifted appends) pays this full
        re-derive again (rather than requantizing the whole mirror on
        every dirty epoch). No-op in the int8-only layout
        (no storage-dtype source; mutations clip-scatter or rebuild)."""
        if self.vectors is None:
            return
        self.vectors_i8c, self.cscale = quantize_cols_i8(self.vectors)
        self._cscale_np = np.asarray(self.cscale)

    # -- construction --------------------------------------------------------

    @classmethod
    def build(
        cls,
        host_vectors: Optional[np.ndarray],
        active_mask: np.ndarray,
        nlist: Optional[int] = None,
        dim: Optional[int] = None,
        iters: int = 8,
        seed: int = 0,
        warm_centroids: Optional[np.ndarray] = None,
        dev_vectors=None,
        storage_dtype: Optional[str] = None,
        i8_only: bool = False,
        dequant_scale=None,
    ) -> "IVFIndex":
        """Train + lay out the IVF mirror.

        When `dev_vectors` (the engine's HBM-resident corpus mirror, any
        storage dtype) is given, the whole build runs on device — active-row
        gather, k-means, assignment, cluster reorder — and the only
        host<->device traffic is the int32 row/order tables (~4 bytes/row
        each way). `host_vectors` may then be None. Otherwise the active
        rows are uploaded once and reordered on device. The IVF mirror keeps
        `dev_vectors`'s dtype (or `storage_dtype`): bfloat16 storage halves
        the mirror's device residency and the bytes the probe reads, and
        the exact rescore bounds recall loss (~0.994 at bf16, same as the
        engine's bf16 exact path)."""
        size = (host_vectors if host_vectors is not None
                else dev_vectors).shape[0]
        dim = (dim if dim is not None
               else (host_vectors if host_vectors is not None
                     else dev_vectors).shape[1])
        act_rows = np.nonzero(active_mask[:size])[0]
        n_active = act_rows.shape[0]
        if n_active == 0:
            raise ValueError("cannot build IVF over an empty corpus")
        nlist = int(nlist) if nlist else default_nlist(n_active)
        nlist = min(nlist, n_active)

        if storage_dtype == "int4" and not i8_only:
            # raw nibbles cannot be scored and a packed mirror cannot be
            # reordered row-wise — int4 corpora always use the int8-only
            # postings layout (the engine enforces this routing)
            raise ValueError(
                "int4 corpora require the int8-only postings layout"
            )
        # packed int4 corpora hand over the (cap, dim//2) byte matrix —
        # every gather below dequantizes via the nibble-unpacking variant
        packed_i4 = storage_dtype == "int4" and dev_vectors is not None
        gather_dq = _gather_rows_dequant_i4 if packed_i4 \
            else _gather_rows_dequant
        if dev_vectors is not None:
            # Gather straight from the engine's device mirror through
            # act_rows everywhere: a contiguous active-row copy would
            # double the corpus's device residency.
            src, sel = dev_vectors, act_rows
        else:
            if storage_dtype in (None, "float32") or i8_only:
                # i8_only: `src` is a temporary f32 staging buffer feeding
                # k-means/assignment/column-quantization only (the tier
                # keeps no storage-dtype mirror) — int8/int4 storage names
                # must not cast true-scale rows here
                np_dtype = np.dtype(Float)
            else:
                import ml_dtypes  # ships with jax

                np_dtype = np.dtype(getattr(ml_dtypes, storage_dtype))
            vecs = np.ascontiguousarray(
                np.asarray(host_vectors)[act_rows]
            ).astype(np_dtype, copy=False)
            src = jax.device_put(vecs)
            sel = np.arange(n_active, dtype=np.int64)

        def take_active(local_idx: np.ndarray):
            gidx = jax.device_put(
                np.ascontiguousarray(sel[local_idx], dtype=np.int32)
            )
            if dequant_scale is not None:
                return gather_dq(src, dequant_scale, gidx)
            return _gather_rows(src, gidx)

        rng = np.random.default_rng(seed)
        if warm_centroids is not None and warm_centroids.shape == (nlist, dim):
            init = jax.device_put(np.ascontiguousarray(warm_centroids, Float))
            train_iters = max(0, min(iters, 2))  # refresh only; 0 = as saved
        else:
            pick = rng.choice(n_active, size=nlist, replace=False)
            init = take_active(pick).astype(jnp.float32)
            train_iters = iters
        if train_iters:
            # Train on a sample (the standard IVF recipe): Lloyd converges on
            # ~50 points per list, so huge corpora don't pay full-sweep cost
            # per iteration. Final assignment still uses every row.
            n_train = min(n_active, max(nlist * 50, 10_000))
            if n_train < n_active:
                tr = np.sort(rng.choice(n_active, size=n_train, replace=False))
            else:
                tr = np.arange(n_active)
            train_vecs = take_active(tr).astype(jnp.float32)
            train_mask = jax.device_put(np.ones(train_vecs.shape[0], bool))
            centroids = _kmeans(train_vecs, train_mask, init, nlist=nlist,
                                iters=train_iters)
            del train_vecs
        else:
            centroids = init
        # Chunked assignment: a single-shot argmax over (n, nlist) scores
        # materializes n*nlist*4 bytes (22 GB at 2M x 2828); per chunk the
        # score block stays ~1.5 GB.
        assign = np.empty(n_active, dtype=np.int64)
        a_chunk = 131_072
        for s in range(0, n_active, a_chunk):
            e = min(n_active, s + a_chunk)
            assign[s:e] = np.asarray(
                _assign(take_active(np.arange(s, e)), centroids)
            )

        # cluster-contiguous reorder + tile padding. The slack beyond
        # n_active is the *overflow region*: incremental updates append
        # there (cluster id = nlist, probed by every query) so small
        # mutation sets never trigger a full reorder — the reference's
        # incremental `add_with_ids` policy (picovdb/pico_vdb.py:884-905)
        # re-designed for a device-resident layout.
        order = np.argsort(assign, kind="stable")
        sorted_clusters = assign[order]
        slack = max(IVF_BN, int(0.04 * n_active))
        cap_ivf = round_up(n_active + slack, IVF_BN)
        n_tiles = cap_ivf // IVF_BN

        i8_buf = i8_scales = None
        if i8_only:
            # int8-ONLY postings: never materialize a storage-dtype IVF
            # mirror next to the corpus — near the device memory limit the
            # classic layout's extra ~corpus-sized mirror cannot fit, while
            # corpus + 1 B/element postings can. Two chunked passes over the reorder: reduce
            # the per-column abs-max, then quantize each gathered chunk
            # against the shared scales straight into the int8 buffer.
            # The exact rescore reads the ENGINE corpus by slot id at
            # query time (see search_async), so returned scores keep
            # storage-dtype precision.
            gsel = (
                sel[order] if dev_vectors is not None else order
            ).astype(np.int32)
            chunk = 262_144

            def fetch(lo, hi):
                gidx = jax.device_put(gsel[lo:hi])
                if dequant_scale is not None:
                    return gather_dq(src, dequant_scale, gidx)
                return _gather_rows(src, gidx)

            cmax = np.zeros(dim, np.float32)
            for s0 in range(0, n_active, chunk):
                rows = fetch(s0, s0 + chunk)
                cmax = np.maximum(cmax, np.asarray(colmax_abs(rows)))
            cs_np = (np.maximum(cmax, 1e-30) / 127.0).astype(np.float32)
            i8_scales = jax.device_put(cs_np)
            i8_buf = jnp.zeros((cap_ivf, dim), jnp.int8)
            for s0 in range(0, n_active, chunk):
                rows = fetch(s0, s0 + chunk)
                q8 = quantize_cols_scaled_i8(rows, i8_scales)
                dst = jax.device_put(
                    np.arange(s0, min(n_active, s0 + chunk), dtype=np.int32)
                )
                i8_buf = _scatter_rows_ivf(i8_buf, dst, q8)
            ivf_vecs = None
        elif dev_vectors is not None:
            # gather global slot order from the (shared, undonated) mirror
            ivf_vecs = _reorder_pad_shared(
                src,
                jax.device_put(sel[order].astype(np.int32)),
                cap_ivf,
            )
        else:
            # donation aliases only when the padded output keeps the
            # source's shape; otherwise it just warns (shape change)
            reorder = (_reorder_pad if int(src.shape[0]) == cap_ivf
                       else _reorder_pad_shared)
            ivf_vecs = reorder(
                src, jax.device_put(order.astype(np.int32)), cap_ivf
            )
        ivf_slots = np.full(cap_ivf, -1, dtype=np.int32)
        ivf_slots[:n_active] = act_rows[order].astype(np.int32)
        ivf_cluster = np.full(cap_ivf, nlist, dtype=np.int32)  # pad bucket
        ivf_cluster[:n_active] = sorted_clusters
        ivf_act = np.zeros(cap_ivf, dtype=bool)
        ivf_act[:n_active] = True

        nlist_pad = round_up(nlist + 1, 8)  # +1 pad bucket, align sublanes
        c2t = np.zeros((nlist_pad, n_tiles), dtype=Float)
        tiles_of_rows = np.arange(cap_ivf) // IVF_BN
        c2t[ivf_cluster, tiles_of_rows] = 1.0
        c2t[nlist] = 0.0  # pad bucket probes nothing

        cent_np = np.zeros((nlist_pad, dim), dtype=Float)
        cent_np[:nlist] = np.asarray(centroids)

        starts = np.searchsorted(sorted_clusters, np.arange(nlist + 1))
        seg_starts = np.concatenate(
            [starts, [cap_ivf]]
        ).astype(np.int32)  # overflow/pad region = [n_active, cap_ivf)

        idx = cls(
            centroids=jax.device_put(cent_np),
            vectors=ivf_vecs,
            slots=jax.device_put(ivf_slots),
            row_cluster=jax.device_put(ivf_cluster),
            active=jax.device_put(ivf_act),
            cluster2tile=jax.device_put(c2t),
            nlist=nlist,
            n_tiles=n_tiles,
            dim=dim,
            seg_starts=jax.device_put(seg_starts),
        )
        if i8_only:
            idx.vectors_i8c = i8_buf
            idx.cscale = i8_scales
            idx._cscale_np = cs_np
        idx._host_blob = {
            "centroids": cent_np[:nlist],
            "assign_rows": act_rows.astype(np.int64),
            "assign_cluster": assign.astype(np.int32),
            "nlist": np.asarray(nlist),
        }
        # host-side bookkeeping for incremental updates
        s2r = np.full(
            int(act_rows.max()) + 1 if n_active else 1, -1, dtype=np.int64
        )
        s2r[act_rows[order]] = np.arange(n_active, dtype=np.int64)
        idx._slot2row = s2r
        idx._n_used = n_active
        idx._n_build = n_active
        idx._blob_stale = False
        return idx

    # -- incremental maintenance ------------------------------------------

    def update(
        self,
        changed_slots: np.ndarray,
        rows: Optional[np.ndarray],
        active_flags: np.ndarray,
    ) -> bool:
        """Apply a small mutation set in place; False = caller must rebuild.

        Deletions/updates deactivate the old IVF row; new/updated vectors
        append to the overflow region (always probed). Returns False when
        the overflow region is exhausted — the analog of the reference's
        incremental-vs-full rebuild threshold (picovdb/pico_vdb.py:884-921),
        where the engine falls back to a full (re)build.

        int8-only layout: appended rows requantize against the FROZEN
        build-time corpus-global column scales (selection-only data — the
        exact rescore re-reads the engine corpus by slot); a clip-fraction
        guard (`PICOVDB_IVF_I8_CLIP_MAX`, default 5% of components)
        refuses the in-place path when new rows fall outside the
        build-time dynamic range, since clip bias could push a true
        winner out of the k_sel guard band.
        """
        i8_only = self.vectors is None
        store = self.vectors_i8c if i8_only else self.vectors
        changed_slots = np.asarray(changed_slots, dtype=np.int64)
        n_new = int(active_flags.sum())
        if self._n_used + n_new > store.shape[0]:
            return False
        q8_new = None
        if i8_only and n_new:
            rows_f = np.asarray(rows[active_flags], dtype=np.float32)
            scaled = np.rint(rows_f / self._cscale_np)
            clipped = float((np.abs(scaled) > 127).mean())
            self.last_update_clip_fraction = clipped
            if clipped > _i8_clip_max():
                return False
            q8_new = np.clip(scaled, -127, 127).astype(np.int8)

        # grow the slot map if the engine's slot table grew
        max_slot = int(changed_slots.max()) if changed_slots.size else 0
        if max_slot >= self._slot2row.shape[0]:
            grown = np.full(max_slot + 1, -1, dtype=np.int64)
            grown[: self._slot2row.shape[0]] = self._slot2row
            self._slot2row = grown

        old_rows = self._slot2row[changed_slots]
        old_rows = old_rows[old_rows >= 0]
        new_slots = changed_slots[active_flags]
        start = self._n_used
        new_rows = np.arange(start, start + n_new, dtype=np.int64)
        self._slot2row[changed_slots] = -1
        self._slot2row[new_slots] = new_rows
        self._n_used = start + n_new
        self._blob_stale = True

        # Device scatters (tiny arrays; donated in-place updates). Sizes
        # pad to power-of-two buckets — with a 1024-row floor on capacity
        # stores (utils.scatter_bucket) — by REPEATING the last entry
        # (duplicate indices carry identical values: idempotent), so every
        # small epoch reuses the ONE executable set warm_update_path
        # pre-compiles at build time (otherwise each jit first-compiles
        # at its own shape inside a serving epoch).
        mb = scatter_floor(int(store.shape[0]))
        if old_rows.size:
            self.active = _scatter_set(
                self.active,
                jax.device_put(_pad_pow2(old_rows.astype(np.int32), mb)),
                _np_scalar(False, bool),
            )
        if n_new:
            idx32 = jax.device_put(_pad_pow2(new_rows.astype(np.int32), mb))
            if i8_only:
                self.vectors_i8c = _scatter_rows_ivf(
                    self.vectors_i8c, idx32,
                    jax.device_put(
                        _pad_pow2(np.ascontiguousarray(q8_new), mb)
                    ),
                )
            else:
                self.vectors = _scatter_rows_ivf(
                    self.vectors, idx32,
                    jax.device_put(_pad_pow2(np.ascontiguousarray(
                        rows[active_flags], dtype=Float
                    ), mb)),
                )
            self.slots = _scatter_rows_ivf(
                self.slots, idx32,
                jax.device_put(_pad_pow2(new_slots.astype(np.int32), mb)),
            )
            self.row_cluster = _scatter_set(
                self.row_cluster, idx32, _np_scalar(self.nlist, np.int32)
            )
            self.active = _scatter_set(
                self.active, idx32, _np_scalar(True, bool)
            )
            # mark the overflow tiles hot for the pad/overflow bucket
            tiles = np.unique(new_rows // IVF_BN)
            self.cluster2tile = _set_tile_cells(
                self.cluster2tile,
                jax.device_put(_pad_pow2(tiles.astype(np.int32))),
                _np_scalar(self.nlist, np.int32),
                _np_scalar(1.0, np.float32),
            )
            if not i8_only and self.vectors_i8c is not None:
                # classic-layout mirror maintenance, O(changed): appended
                # rows requantize against the FROZEN build-time column
                # scales (refresh_i8_mirror snapshots them) under the same
                # clip guard as the i8-only layout; a guard trip means the
                # appends drifted outside the built dynamic range — pay
                # one full re-derive with fresh scales (correctness is
                # unaffected either way: the mirror is selection-only).
                rows_f = np.asarray(rows[active_flags], dtype=np.float32)
                if self._cscale_np is None:
                    self.refresh_i8_mirror()
                else:
                    scaled = np.rint(rows_f / self._cscale_np)
                    clipped = float((np.abs(scaled) > 127).mean())
                    self.last_update_clip_fraction = clipped
                    if clipped > _i8_clip_max():
                        self.refresh_i8_mirror()
                    else:
                        self.vectors_i8c = _scatter_rows_ivf(
                            self.vectors_i8c, idx32,
                            jax.device_put(_pad_pow2(
                                np.clip(scaled, -127, 127).astype(np.int8),
                                mb,
                            )),
                        )
        return True

    def warm_update_path(self, bucket: int = 1024) -> None:
        """Pre-compile the incremental-update executables at this layout's
        shapes with IDENTITY writes on the live buffers (scatter back what
        is already there), so the first dirty epoch pays execution cost
        only: at capacity shapes the first-use XLA compiles of these
        scatters take seconds, all inside the first epoch. One compile set
        covers every
        epoch of up to `bucket` changed rows (update() pads each scatter
        to a power-of-two bucket); larger epochs compile one more set at
        their own bucket on first use.
        """
        store = self.vectors_i8c if self.vectors is None else self.vectors
        if store is None:
            return
        idx_np = np.zeros(bucket, dtype=np.int32)
        idx = jax.device_put(idx_np)
        # identity rows: fetch row 0 once, write it back `bucket` times
        # (duplicate indices with identical values are well-defined);
        # values travel host->device exactly like update()'s — int8 bytes
        # on the i8-only layout, Float rows on the classic layout (the jit
        # casts to the mirror dtype; f32 round-trips bf16 exactly) — so
        # shape, dtype, sharding and layout all match the real call.
        row0 = np.asarray(store[0:1])
        if self.vectors is not None:
            row0 = row0.astype(Float)
        self_rows = jax.device_put(
            np.ascontiguousarray(np.repeat(row0, bucket, axis=0))
        )
        if self.vectors is None:
            self.vectors_i8c = _scatter_rows_ivf(
                self.vectors_i8c, idx, self_rows
            )
        else:
            self.vectors = _scatter_rows_ivf(self.vectors, idx, self_rows)
            if self.vectors_i8c is not None:
                # classic-layout mirror: its O(changed) maintenance
                # scatters int8 bytes — warm with the stored row
                m0 = np.asarray(self.vectors_i8c[0:1])
                self.vectors_i8c = _scatter_rows_ivf(
                    self.vectors_i8c, idx,
                    jax.device_put(np.repeat(m0, bucket, axis=0)),
                )
        slot0 = np.asarray(self.slots[0:1]).astype(np.int32)
        self.slots = _scatter_rows_ivf(
            self.slots, idx, jax.device_put(np.repeat(slot0, bucket))
        )
        cl0 = _np_scalar(np.asarray(self.row_cluster[0]), np.int32)
        self.row_cluster = _scatter_set(self.row_cluster, idx, cl0)
        act0 = _np_scalar(np.asarray(self.active[0]), bool)
        self.active = _scatter_set(self.active, idx, act0)
        # cluster2tile identity: write cell (nlist, 0)'s current value back
        tiles = jax.device_put(np.zeros(8, dtype=np.int32))
        cur = _np_scalar(np.asarray(self.cluster2tile[self.nlist, 0]),
                         np.float32)
        self.cluster2tile = _set_tile_cells(
            self.cluster2tile, tiles, _np_scalar(self.nlist, np.int32), cur
        )

    @property
    def overflow_fraction(self) -> float:
        """Fraction of rows appended to the always-probed overflow region
        since the last full build (dead holes count too — both grow the
        per-query scan overhead until the next rebuild)."""
        used = max(1, self._n_used)
        return float(self._n_used - self._n_build) / used

    def to_blob(self) -> Optional[dict]:
        """Persistable sidecar (counterpart of faiss.write_index at
        picovdb/pico_vdb.py:362). After incremental updates the row/cluster
        lists are refreshed from the live mirror so a reload can reuse the
        trained centroids without a stale-sidecar retrain."""
        if self._host_blob is not None and self._blob_stale:
            live_slots = np.nonzero(self._slot2row >= 0)[0].astype(np.int64)
            row_cluster = np.asarray(self.row_cluster)
            self._host_blob = {
                "centroids": self._host_blob["centroids"],
                "assign_rows": live_slots,
                "assign_cluster": row_cluster[
                    self._slot2row[live_slots]
                ].astype(np.int32),
                "nlist": np.asarray(self.nlist),
            }
            self._blob_stale = False
        return self._host_blob

    @classmethod
    def from_blob(
        cls,
        blob: dict,
        host_vectors: np.ndarray,
        active_mask: np.ndarray,
        dim: int,
        dev_vectors=None,
        storage_dtype: Optional[str] = None,
        i8_only: bool = False,
        dequant_scale=None,
    ) -> Optional["IVFIndex"]:
        """Rebuild from a persisted sidecar without retraining k-means.

        Counterpart of faiss.read_index + the reference's self-healing
        fallback (picovdb/pico_vdb.py:260-283): returns None when the blob
        no longer matches the store (caller retrains).
        """
        try:
            cent = np.asarray(blob["centroids"], dtype=Float)
            if cent.ndim != 2 or cent.shape[1] != dim:
                return None
            # host_vectors may be None when a device corpus serves the
            # build (quantized-checkpoint reload: the f32 matrix never
            # exists) — only its row count is needed here
            size = (
                active_mask.shape[0] if host_vectors is None
                else host_vectors.shape[0]
            )
            act_rows = np.nonzero(active_mask[:size])[0]
            saved_rows = np.asarray(blob["assign_rows"])
            if act_rows.shape != saved_rows.shape or not np.array_equal(
                act_rows, saved_rows
            ):
                return None  # active set changed since save -> retrain
            return cls.build(
                host_vectors if dev_vectors is None else None,
                active_mask,
                nlist=int(blob["nlist"]),
                dim=dim,
                warm_centroids=cent,
                iters=0,
                dev_vectors=dev_vectors,
                storage_dtype=storage_dtype,
                i8_only=i8_only,
                dequant_scale=dequant_scale,
            )
        except Exception:
            return None

    # -- search ----------------------------------------------------------------

    def search(self, queries, k: int, ef: int, dev,
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Probed masked top-k; returns host (vals, slot_ids) of (Q, k).

        `nprobe` overrides the ef->nprobe mapping when given (the engine's
        `ivf_nprobe` ctor knob).
        """
        vals, slot_ids, num_q = self.search_async(queries, k, ef, dev, nprobe)
        vals_np = np.asarray(vals)[:num_q, :k]
        slots_np = np.asarray(slot_ids)[:num_q, :k]
        if not np.isfinite(vals_np).any():
            # Every probed cluster was empty (stale centroids / tiny nprobe)
            # yet the engine routed here because candidates exist — fall back
            # to the exact scan rather than returning spuriously empty
            # results (self-healing, like the reference's FAISS load
            # fallback at picovdb/pico_vdb.py:260-283).
            return dev.query(np.asarray(queries)[:num_q], k, None)
        return vals_np, slots_np

    def search_async(self, queries, k: int, ef: int, dev,
                     nprobe: Optional[int] = None):
        """Dispatch a probed top-k without blocking.

        Returns (vals_dev, slot_ids_dev, num_q) — device arrays callers
        slice as [:num_q, :k] after np.asarray — so serving paths can
        pipeline several dispatches ahead of the host fetches (same
        contract as DeviceIndex.query_async).
        """
        if nprobe is None:
            nprobe = ef_to_nprobe(ef, self.nlist)
        nprobe = int(max(1, min(self.nlist, nprobe)))
        num_q = queries.shape[0]
        q_pad = max(8, next_pow2(num_q))
        # Pad with copies of the first query, not zeros: zero rows
        # normalize to e0 and would probe nprobe *extra* clusters, growing
        # the hot-tile union (~2x at Q=1). Duplicate probes are free.
        if isinstance(queries, np.ndarray):
            if queries.dtype != Float and queries.dtype.itemsize > 2:
                queries = np.ascontiguousarray(queries, dtype=Float)
            if q_pad != num_q:
                buf = np.empty((q_pad, self.dim), dtype=queries.dtype)
                buf[:num_q] = queries
                buf[num_q:] = queries[0]
                queries = buf
            q_dev = jax.device_put(np.ascontiguousarray(queries))
            if q_dev.dtype != jnp.float32:
                # compact query wire (engine._wire_encode): upload the
                # narrow batch, widen on device before the probe
                q_dev = q_dev.astype(jnp.float32)
        else:
            q_dev = queries.astype(jnp.float32)
            if q_pad != num_q:
                q_dev = jnp.pad(q_dev, ((0, q_pad - num_q), (0, 0)),
                                mode="edge")
        g_tiles = hot_tile_bound(nprobe, self.nlist, self.n_tiles, q_pad)
        slot_rescore = self.vectors is None  # int8-only layout
        postings = self.vectors_i8c if slot_rescore else self.vectors
        use_i8_sel = (self.vectors_i8c is not None) or slot_rescore
        k_sel = k + _ivf_guard(use_i8_sel, self.dim)
        if slot_rescore:
            if dev is None or getattr(dev, "vectors", None) is None:
                raise RuntimeError(
                    "int8-only IVF needs the engine's device corpus "
                    "mirror for the exact rescore"
                )
            rescore_v = dev.vectors
            rescore_scale = getattr(dev, "vstore_scale", None)
            compute_dtype_name = None  # only the int8 postings scan
            packed_i4 = getattr(dev, "storage_dtype", None) == "int4"
        else:
            rescore_v = self.vectors
            rescore_scale = None
            compute_dtype_name = (
                None if self.vectors.dtype == jnp.float32
                else str(self.vectors.dtype)
            )
            packed_i4 = False
        tile_step = budget_block(
            g_tiles,
            hot_tile_bytes(q_pad, self.dim,
                           1 if use_i8_sel else postings.dtype.itemsize),
            temp_budget_of(dev),
        )
        fn = _make_ivf_search(
            k, nprobe, self.nlist, compute_dtype_name, g_tiles,
            self.vectors_i8c is not None, slot_rescore, k_sel, packed_i4,
            tile_step,
        )
        with dispatch_slot_of(dev):
            vals, slot_ids = fn(
                q_dev,
                self.centroids,
                rescore_v,
                self.slots,
                self.seg_starts,
                self.active,
                self.cluster2tile,
                self.vectors_i8c,
                self.cscale,
                rescore_scale,
            )
        return vals, slot_ids, num_q


def hot_tile_bound(nprobe: int, nlist: int, n_tiles: int, q_pad: int) -> int:
    """Static bound on the hot tiles one probed batch scans.

    The union over the (padded) batch probes at most q_pad*nprobe clusters,
    but draws overlap, so the expected union is
    nlist*(1-(1-nprobe/nlist)^Q); expected distinct hot tiles follow the
    same birthday bound over the tiles each cluster spans. A 1.35x margin
    plus 16, rounded up to 64-tile buckets (distinct batch sizes share one
    compiled search), keeps truncation rare, and truncation is safe: the
    sorted hot list sheds the highest-id probed tiles, never the overflow
    tiles (see `_probe_preamble`).
    """
    p_cluster = min(1.0, nprobe / nlist)
    uniq = nlist * (1.0 - (1.0 - p_cluster) ** q_pad) + 1
    span = n_tiles / nlist + 1.0  # tiles per cluster (avg)
    e_hot = n_tiles * (1.0 - math.exp(-uniq * span / n_tiles))
    return min(n_tiles, round_up(int(1.35 * e_hot) + 16, 64))


def temp_budget_of(dev) -> Optional[int]:
    """The store's per-dispatch temporary budget (DeviceIndex.temp_budget);
    None (no bound) without a store, or with a stand-in that only holds
    the corpus arrays."""
    budget = getattr(dev, "temp_budget", None)
    return budget() if budget is not None else None


def dispatch_slot_of(dev):
    """The store's dispatch slot (DeviceIndex.dispatch_slot); no slot
    without a store, or with a stand-in that only holds the corpus
    arrays."""
    slot = getattr(dev, "dispatch_slot", None)
    return slot() if slot is not None else contextlib.nullcontext()


def hot_tile_bytes(num_q: int, dim: int, itemsize: int) -> int:
    """Temporary device bytes per gathered hot tile: its postings rows and
    their (Q, rows) scores, mask and selection copies."""
    return IVF_BN * (dim * itemsize + 12 * num_q)


def probe_scan_local(q, centroids, vectors, slots, seg_starts, active,
                     cluster2tile, *, k: int, k_sel: int, nprobe: int,
                     nlist: int, g_tiles: Optional[int], compute_dtype,
                     vectors_i8=None, cscale=None,
                     rescore_by_slot: bool = False, rescore_scale=None,
                     rescore_packed_i4: bool = False,
                     tile_step: Optional[int] = None):
    """Probe clusters -> hot-tile list -> gathered hot-tile scan -> exact
    rescore -> slot translation, over ONE device's local IVF arrays.

    `q` must already be L2-normalized. Traceable both under plain jit (the
    single-device tier) and inside a shard_map body (the per-shard mesh
    tier, parallel/ivf_mesh.py): every op is local — no collectives.
    Returns ((Q, k) f32 exact scores, (Q, k) int32 slot ids; -1 marks
    missing candidates).

    The scan gathers the first `g_tiles` sorted hot tiles of the postings
    (`IVF_BN` rows each), masks rows outside the probed clusters and steps
    at or past the live hot count, scores them in one dot and keeps the
    top `k_sel`. Cold tiles are never read. `tile_step` (sized from the
    store's temporary budget, see `hot_tile_bytes`) walks the hot list that many tiles at a time with a
    running top-k merge instead, bounding the gathered copy.

    `vectors_i8` + `cscale` (the column-scaled int8 postings) score with an
    s8 x s8 -> s32 dot, the column scales folded into the query; the exact
    rescore still reads the storage-dtype `vectors`.

    `rescore_by_slot=True` (the int8-only layout): `vectors` is the
    ENGINE's slot-indexed corpus mirror, not an IVF-ordered mirror — the
    winners' IVF rows translate to slot ids first and the rescore gathers
    corpus rows by slot. Postings geometry then comes from `vectors_i8`.
    """
    from .exact import _dot, blocked_topk

    num_q = q.shape[0]
    use_i8 = vectors_i8 is not None
    postings = vectors_i8 if use_i8 else vectors
    cap_ivf, dim = postings.shape
    n_tiles = cap_ivf // IVF_BN

    row_mask, hot, n_hot, grid_b = _probe_preamble(
        q, centroids, active, seg_starts, cluster2tile,
        nprobe=nprobe, nlist=nlist, g_tiles=g_tiles,
        cap_ivf=cap_ivf, n_tiles=n_tiles, bn=IVF_BN,
    )
    if use_i8:
        q_scan = fold_queries_i8(q, cscale)
    elif compute_dtype is not None:
        q_scan = q.astype(compute_dtype)
    else:
        q_scan = q
    v_tiles = postings.reshape(n_tiles, IVF_BN, dim)
    live_step = jnp.arange(grid_b, dtype=jnp.int32) < n_hot
    hot_mask = (
        jnp.take(row_mask.reshape(n_tiles, IVF_BN), hot, axis=0)
        & live_step[:, None]
    ).reshape(-1)

    def score_rows(start, n):
        tiles = jax.lax.dynamic_slice_in_dim(hot, start // IVF_BN,
                                             n // IVF_BN)
        v = jnp.take(v_tiles, tiles, axis=0).reshape(n, dim)
        if use_i8:
            return _dot(q_scan, v, jnp.int32).astype(jnp.float32)
        if compute_dtype is not None:
            v = v.astype(compute_dtype)
        return _dot(q_scan, v)

    block = None if tile_step is None else tile_step * IVF_BN
    vals, pos = blocked_topk(score_rows, hot_mask, min(k_sel, grid_b * IVF_BN),
                             block, num_q)
    idxs = jnp.take(hot, pos // IVF_BN) * IVF_BN + pos % IVF_BN
    if rescore_by_slot:
        return _rescore_by_slot(q, vectors, slots, vals, idxs, k,
                                corpus_scale=rescore_scale,
                                packed_i4=rescore_packed_i4)
    vals, idxs = rescore_exact(q, vectors, vals, idxs)
    vals, idxs = vals[:, :k], idxs[:, :k]
    # translate IVF rows -> engine slot ids (pad rows carry slot -1)
    slot_ids = jnp.take(slots, idxs, axis=0)
    slot_ids = jnp.where(jnp.isneginf(vals), -1, slot_ids)
    return vals, slot_ids


def _rescore_by_slot(q, corpus, slots, vals, idxs, k, corpus_scale=None,
                     packed_i4: bool = False):
    """Exact rescore for the int8-only layout: translate winner IVF rows
    to engine slot ids, gather the slot-indexed corpus rows, re-rank by
    exact f32 scores (HIGHEST: these are the returned scores). -inf/pad
    candidates stay -inf with slot -1. `corpus_scale` dequantizes an int8
    STORAGE corpus (per-row scales); `packed_i4` additionally unpacks a
    packed-nibble int4 STORAGE corpus before the dot."""
    sl = jnp.take(slots, idxs, axis=0)  # (Q, k_run)
    safe = jnp.maximum(sl, 0)
    gathered = jnp.take(corpus, safe, axis=0)
    if packed_i4:
        gathered = unpack_i4(gathered)
    exact = jnp.einsum("qd,qkd->qk", q, gathered.astype(jnp.float32),
                       preferred_element_type=jnp.float32,
                       precision=jax.lax.Precision.HIGHEST)
    if corpus_scale is not None:
        exact = exact * jnp.take(corpus_scale, safe)
    exact = jnp.where(jnp.isneginf(vals) | (sl < 0), -jnp.inf, exact)
    order = jnp.argsort(-exact, axis=1)
    out_vals = jnp.take_along_axis(exact, order, axis=1)[:, :k]
    out_slots = jnp.take_along_axis(sl, order, axis=1)[:, :k]
    out_slots = jnp.where(jnp.isneginf(out_vals), -1, out_slots)
    return out_vals, out_slots.astype(jnp.int32)


def _probe_preamble(q, centroids, active, seg_starts, cluster2tile, *,
                    nprobe: int, nlist: int, g_tiles: Optional[int],
                    cap_ivf: int, n_tiles: int, bn: int):
    """Probe clusters and build the (row_mask, hot tile list, n_hot,
    grid_b) quadruple the probe scan consumes."""
    # 1) probe clusters (HIGHEST like every f32 scoring dot: the probe
    # choice among near-equal centroids must not hang on TF32 rounding)
    cs = jnp.matmul(q, centroids.T,
                    precision=jax.lax.Precision.HIGHEST)  # (Q, nlist_pad)
    cs = jnp.where(
        jax.lax.broadcasted_iota(jnp.int32, cs.shape, 1) < nlist,
        cs,
        -jnp.inf,
    )
    _, probed = jax.lax.top_k(cs, min(nprobe, nlist))  # (Q, nprobe)

    # 2) union-over-batch cluster mask -> row mask and hot tile list
    onehot = jax.nn.one_hot(
        probed.reshape(-1), centroids.shape[0], dtype=jnp.float32
    )
    cluster_mask = jnp.clip(onehot.sum(0), 0.0, 1.0)  # (nlist_pad,)
    # the overflow bucket (incrementally appended rows) is probed by
    # every query; freshly built indexes have no hot tiles for it, so
    # this costs nothing until the first incremental update
    cluster_mask = cluster_mask.at[nlist].set(1.0)
    # Row mask via segment boundaries: the layout is cluster-contiguous,
    # so per-row probe membership is piecewise-constant — scatter +/-1
    # at the 2*(nlist+1) segment edges and cumsum, instead of gathering
    # a (cap_ivf,)-row table.
    cm_main = cluster_mask[: nlist + 1]
    delta = jnp.zeros(cap_ivf + 1, jnp.float32)
    delta = delta.at[seg_starts[:-1]].add(cm_main)
    delta = delta.at[seg_starts[1:]].add(-cm_main)
    row_mask = (jnp.cumsum(delta)[:cap_ivf] > 0.5) & active
    tile_hot = jnp.matmul(cluster_mask, cluster2tile,
                          precision=jax.lax.Precision.HIGHEST) > 0
    n_hot = tile_hot.sum().astype(jnp.int32)
    # Compacted hot-tile ids; the tail repeats the last hot tile (those
    # steps are masked off by the caller). Overflow-region tiles
    # (incrementally appended rows, ids >= ov_tile0) sort FIRST (negative
    # keys): the static bound below truncates the sorted list, and
    # shedding probed-cluster tiles costs a little recall on old rows,
    # while shedding overflow tiles would silently exclude exactly the
    # most recently upserted vectors.
    ov_tile0 = seg_starts[nlist] // jnp.int32(bn)
    iota_t = jax.lax.broadcasted_iota(jnp.int32, (n_tiles,), 0)
    sort_key = jnp.where(iota_t >= ov_tile0, iota_t - n_tiles, iota_t)
    tile_ids = jnp.where(tile_hot, sort_key, jnp.int32(n_tiles))
    # Static bound: only the first `grid_b` sorted hot tiles are
    # scanned. `g_tiles` (see hot_tile_bound) rarely truncates in
    # practice; when it does, the highest-id non-overflow hot tiles are
    # dropped and the recall sweep reflects it honestly.
    grid_b = min(g_tiles, n_tiles) if g_tiles else n_tiles
    hot = jnp.sort(tile_ids)[:grid_b]
    hot = jnp.where(hot < 0, hot + n_tiles, hot)
    n_hot = jnp.minimum(n_hot, jnp.int32(grid_b))
    last_hot = hot[jnp.maximum(n_hot - 1, 0)]
    hot = jnp.where(hot >= n_tiles, last_hot, hot)
    # n_hot == 0 (every probed cluster empty — possible with stale warm
    # centroids) leaves last_hot == n_tiles: clamp so the gather stays in
    # bounds (those steps are masked off).
    hot = jnp.minimum(hot, jnp.int32(n_tiles - 1))
    return row_mask, hot, n_hot, grid_b


@functools.lru_cache(maxsize=256)
def _make_ivf_search(k: int, nprobe: int, nlist: int,
                     compute_dtype_name: Optional[str] = None,
                     g_tiles: Optional[int] = None,
                     use_i8: bool = False,
                     slot_rescore: bool = False,
                     k_sel: Optional[int] = None,
                     packed_i4: bool = False,
                     tile_step: Optional[int] = None):
    """Jitted single-device probed search (see `probe_scan_local`).

    `k_sel` (selection band incl. the guard, see `_ivf_guard`) is an
    explicit cache-key argument: the caller resolves the guard env/dim
    policy BEFORE this lru-cached factory so env changes stay effective."""
    if k_sel is None:
        k_sel = k + (6 if use_i8 else 4)
    compute_dtype = (
        jnp.dtype(compute_dtype_name) if compute_dtype_name else None
    )

    def fn(q, centroids, vectors, slots, seg_starts, active, cluster2tile,
           vectors_i8=None, cscale=None, rescore_scale=None):
        from .exact import normalize_on_device

        q = normalize_on_device(q)
        return probe_scan_local(
            q, centroids, vectors, slots, seg_starts, active, cluster2tile,
            k=k, k_sel=k_sel, nprobe=nprobe, nlist=nlist, g_tiles=g_tiles,
            compute_dtype=compute_dtype,
            vectors_i8=vectors_i8, cscale=cscale,
            rescore_by_slot=slot_rescore, rescore_scale=rescore_scale,
            rescore_packed_i4=packed_i4, tile_step=tile_step,
        )

    return jax.jit(fn)
