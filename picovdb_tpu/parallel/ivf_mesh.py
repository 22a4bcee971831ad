"""Sharded IVF tier: shared centroids, per-shard postings, cross-device merge.

Replaces the reference's FAISS HNSW acceleration tier
(picovdb/pico_vdb.py:171-212) at multi-chip scale — the round-2 gap where a
mesh store with `index="ivf"` fell back to the sharded exact scan.

Design (classic distributed IVF, re-laid-out for a device mesh):

  * **One shared centroid table** (replicated, ~nlist x dim — tiny): k-means
    trains once on a sample of the whole corpus, so probing semantics are
    identical to the single-device tier and recall does not depend on the
    shard count.
  * **Per-shard postings**: each shard holds its own cluster-contiguous
    reorder of the rows it owns — local `seg_starts`, `cluster2tile`, and a
    `slots` table that maps local IVF rows straight to *global* engine slot
    ids. Random row->shard partition keeps every cluster's posting list
    spread ~uniformly across shards, so per-shard hot-tile counts stay
    balanced.
  * **Search** runs under `shard_map`: queries are replicated; every shard
    probes the shared centroids (redundant (Q, nlist) matmul — far cheaper
    than a collective), builds its local hot-tile list, runs the same
    hot-tile probe scan as the single-device tier
    (`ops.ivf.probe_scan_local`), and emits a local top-k of (exact score,
    global slot) pairs. The k*nshards candidate slabs merge exactly like the
    sharded exact path (parallel/sharded_query.py): XLA lowers the final
    top-k to an allgather across devices + on-device selection.

Incremental maintenance mirrors the single-device tier's overflow-region
design (ops/ivf.py::IVFIndex.update), re-laid-out per shard: each shard's
postings keep a slack region beyond its built rows (cluster id = nlist,
probed by every query — the same `_probe_preamble` mechanics, which run
per shard here), and `update()` deactivates old rows + appends changed
rows into whichever shards have free overflow space, as tiny sharded
device scatters. No host corpus materialization, no k-means: a mutation
epoch costs O(changed). The engine's `faiss_incremental_threshold_ratio`
knob governs incremental-vs-full exactly like the reference
(picovdb/pico_vdb.py:884-921). The int8-only layout updates in place too:
appended rows requantize against the FROZEN build-time per-shard column
scales (clipping at the int8 rails) and must land on their OWNING corpus
shard (the rescore-locality invariant); a measured clip-fraction guard
(`PICOVDB_IVF_I8_CLIP_MAX`) falls back to a full rebuild when new rows
drift too far outside the build-time dynamic range, since clip bias only
lowers SELECTION scores (the exact rescore re-reads the engine corpus)
but could drop a true winner out of the guard band if extreme.
Sidecar persistence reuses the
single-device blob schema, so `index="ivf"` stores round-trip between mesh
and single-device processes.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

try:  # JAX >= 0.6 exposes shard_map at top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover - older JAX
    from jax.experimental.shard_map import shard_map as _shard_map

from ..constants import Float
from ..utils import budget_block, next_pow2, round_up, scatter_floor
from ..ops.ivf import (
    IVF_BN,
    _assign,
    _i8_clip_max,
    _ivf_guard,
    _ivf_i8_mirror,
    _kmeans,
    default_nlist,
    dispatch_slot_of,
    ef_to_nprobe,
    hot_tile_bound,
    hot_tile_bytes,
    probe_scan_local,
    temp_budget_of,
)
from ..ops.quant import quantize_cols_i8

# Bounded FIFO: keys include id(mesh) and cached closures pin their mesh
# plus compiled executables — unbounded growth leaks dead meshes in
# long-lived processes that recreate meshes or sweep k/nprobe (the exact
# failure sharded_query.py's cache bound fixed after a fuzz-soak OOM).
_CACHE: dict = {}
_CACHE_MAX = 64


@functools.partial(jax.jit, donate_argnums=(0,))
def _mark_overflow_tiles_sharded(c2t, sh, tiles, cluster, value):
    """Write `value` into c2t[sh, cluster, tiles]: c2t is (nshards,
    nlist_pad, n_tiles); (sh, tiles) are parallel (shard id, local tile
    id) pairs. `cluster`/`value` are traced, so the mutation path's
    hot-mark 1.0 and warm_update_path's identity write share one
    executable per operand shape."""
    return c2t.at[sh, jnp.asarray(cluster, jnp.int32), tiles].set(
        jnp.asarray(value, c2t.dtype)
    )


def _quantize_shards_i8(vectors, mesh, shard_axis: str):
    """Per-shard column-scaled int8 mirror of the sharded postings.

    Each shard derives its own (dim,) column scales — scales are folded
    into the query per shard inside the search body, and the exact f32
    rescore runs before the cross-device merge, so cross-shard score comparability
    is unaffected. Returns (v_i8 P(shard, None), cscale (nshards, dim)
    P(shard, None))."""

    def local(v):
        q, s = quantize_cols_i8(v)
        return q, s[None, :]

    return _shard_map(
        local,
        mesh=mesh,
        in_specs=(P(shard_axis, None),),
        out_specs=(P(shard_axis, None), P(shard_axis, None)),
    )(vectors)


class ShardedIVF:
    """Shared-centroid IVF with per-shard postings over a device mesh."""

    def __init__(self, centroids, vectors, slots, active, seg_starts,
                 cluster2tile, nlist: int, n_tiles: int, cap_shard: int,
                 dim: int, mesh, shard_axis: str,
                 vectors_i8c=None, cscale=None,
                 corpus_cap: Optional[int] = None) -> None:
        self.centroids = centroids  # (nlist_pad, dim) replicated f32
        self.vectors = vectors  # (nshards*cap_shard, dim) P(shard, None)
        # slots: (nshards*cap_shard,) P(shard) int32. Classic layout:
        # GLOBAL engine slot ids. int8-only layout (vectors is None):
        # LOCAL corpus-shard row ids — the rescore gathers from the OWNING
        # corpus shard inside shard_map, and the search body re-globalizes
        # with the shard base.
        self.slots = slots
        self.active = active  # (nshards*cap_shard,) P(shard) bool
        self.seg_starts = seg_starts  # (nshards, nlist+2) P(shard, None)
        self.cluster2tile = cluster2tile  # (nshards, nlist_pad, n_tiles)
        self.nlist = nlist
        self.n_tiles = n_tiles  # per shard
        self.cap_shard = cap_shard
        self.dim = dim
        self.mesh = mesh
        self.shard_axis = shard_axis
        # int8-only layout: the corpus capacity the per-shard row->slot
        # mapping was laid out against; a mismatch at query time means the
        # corpus was re-padded (rows moved shards) and the tier is stale.
        self.corpus_cap = corpus_cap
        self._host_blob: Optional[dict] = None
        # incremental-update bookkeeping (host-side; set by `build`):
        # global engine slot -> stacked postings row, per-shard used-row
        # counts, rows-at-build total, and a host mirror of each postings
        # row's cluster id (sidecar refresh after updates). None (with
        # _n_used None) disables in-place updates -> full-rebuild policy.
        self._slot2row: Optional[np.ndarray] = None
        self._n_used: Optional[np.ndarray] = None
        self._n_build: int = 0
        self._row_cluster_np: Optional[np.ndarray] = None
        self._blob_stale = False
        # int8-only layout: frozen build-time per-shard column scales
        # (host mirror) + the corpus-shard row count the owner partition
        # was computed from; observability for the requantize-on-append
        # clip guard (fraction of components clipped by the last update)
        self._cscale_np: Optional[np.ndarray] = None
        self._shard_rows_corpus: int = 0
        self.last_update_clip_fraction: Optional[float] = None
        # per-shard column-scaled int8 postings mirror — same
        # DMA-bound-probe rationale as the single-device tier
        # (ops/ivf._ivf_i8_enabled). In the int8-only layout
        # (vectors is None) the mirror IS the postings store, built by
        # `build` and passed in here.
        self.vectors_i8c = vectors_i8c
        self.cscale = cscale
        if vectors is not None and _ivf_i8_mirror(dim):
            self.vectors_i8c, self.cscale = _quantize_shards_i8(
                self.vectors, mesh, shard_axis
            )
            self._freeze_mirror_scales()

    def _freeze_mirror_scales(self) -> None:
        """Host snapshot of the classic mirror's per-shard column scales —
        update()'s O(changed) requantize-on-append reads them. None when
        the shards aren't addressable from this process (multi-process
        meshes): update then falls back to the full per-shard re-derive."""
        try:
            if self.cscale is not None and getattr(
                self.cscale, "is_fully_addressable", True
            ):
                self._cscale_np = np.asarray(self.cscale)
        except Exception:  # pragma: no cover - best effort
            self._cscale_np = None

    # -- construction ------------------------------------------------------

    @classmethod
    def build(
        cls,
        host_vectors: np.ndarray,
        active_mask: np.ndarray,
        mesh,
        shard_axis: str = "shard",
        nlist: Optional[int] = None,
        dim: Optional[int] = None,
        iters: int = 8,
        seed: int = 0,
        warm_centroids: Optional[np.ndarray] = None,
        storage_dtype: Optional[str] = None,
        i8_only: bool = False,
        corpus_cap: Optional[int] = None,
    ) -> "ShardedIVF":
        """Train shared centroids, lay out per-shard postings, upload sharded.

        The build is host-orchestrated (the mesh tier is (re)built at load /
        bulk-ingest time, where the corpus is host-resident anyway); k-means
        and assignment run on device. Vector payload flows host -> HBM once,
        already in its sharded layout.

        `i8_only=True` (required for int8 STORAGE corpora, where raw
        storage rows cannot be scored without their per-row scales): the
        per-shard postings are a column-scaled int8 mirror ONLY — 1
        B/element beside the corpus — and the exact rescore reads the
        ENGINE's sharded corpus by slot at query time. Rows are then
        partitioned by their OWNING corpus shard (slot // per-shard
        capacity, given via `corpus_cap`) instead of an equal split, so
        the rescore gather stays shard-local (no collectives).
        """
        dim = int(dim if dim is not None else host_vectors.shape[1])
        nshards = mesh.shape[shard_axis]
        size = host_vectors.shape[0]
        act_rows = np.nonzero(active_mask[:size])[0]
        n_active = act_rows.shape[0]
        if n_active == 0:
            raise ValueError("cannot build IVF over an empty corpus")
        nlist = int(nlist) if nlist else default_nlist(n_active)
        nlist = min(nlist, n_active)

        rng = np.random.default_rng(seed)
        # --- shared centroids (train on a sample, device k-means) ---------
        if warm_centroids is not None and warm_centroids.shape == (nlist, dim):
            init = jax.device_put(np.ascontiguousarray(warm_centroids, Float))
            train_iters = max(0, min(iters, 2))
        else:
            pick = act_rows[rng.choice(n_active, size=nlist, replace=False)]
            init = jax.device_put(
                np.ascontiguousarray(host_vectors[pick], dtype=Float)
            )
            train_iters = iters
        if train_iters:
            n_train = min(n_active, max(nlist * 50, 10_000))
            tr = (
                act_rows
                if n_train >= n_active
                else act_rows[
                    np.sort(rng.choice(n_active, size=n_train, replace=False))
                ]
            )
            tv = jax.device_put(
                np.ascontiguousarray(host_vectors[tr], dtype=Float)
            )
            centroids = np.asarray(
                _kmeans(tv, jnp.ones(tv.shape[0], bool), init,
                        nlist=nlist, iters=train_iters)
            )
            del tv
        else:
            centroids = np.asarray(init)

        # --- global assignment (chunked device matmul) --------------------
        cent_dev = jax.device_put(np.ascontiguousarray(centroids, Float))
        assign = np.empty(n_active, dtype=np.int64)
        a_chunk = 131_072
        for s in range(0, n_active, a_chunk):
            e = min(n_active, s + a_chunk)
            assign[s:e] = np.asarray(
                _assign(
                    jax.device_put(
                        np.ascontiguousarray(
                            host_vectors[act_rows[s:e]], dtype=Float
                        )
                    ),
                    cent_dev,
                )
            )

        # --- per-shard cluster-contiguous layout --------------------------
        # Classic layout: contiguous equal split of the active rows
        # (insertion order is effectively random w.r.t. clusters, so
        # posting lists spread uniformly). int8-only layout: rows go to
        # their OWNING corpus shard so the slot rescore is local; active
        # slots are ~uniform over the slot space, so balance is similar.
        # All shards share cap_shard so the stacked arrays are uniform;
        # the slack beyond each shard's built rows is its overflow region
        # for incremental appends (see `update`).
        if i8_only:
            if not corpus_cap or corpus_cap % nshards:
                raise ValueError(
                    f"i8_only mesh IVF needs the corpus capacity "
                    f"(multiple of {nshards}); got {corpus_cap}"
                )
            shard_rows_corpus = corpus_cap // nshards
            owner = act_rows // shard_rows_corpus
            shard_sel = [np.nonzero(owner == s)[0] for s in range(nshards)]
            per = max((int(x.shape[0]) for x in shard_sel), default=1)
        else:
            per = -(-n_active // nshards)  # ceil
            shard_sel = [
                np.arange(s * per, min((s + 1) * per, n_active))
                for s in range(nshards)
            ]
        # Per-shard slack beyond the built rows = the overflow region for
        # incremental updates (cluster id = nlist, probed when occupied) —
        # 4% like the single-device tier (ops/ivf.py::build), but floored
        # at 64 rows, NOT a full IVF_BN tile: the tile rounding below
        # already yields up to IVF_BN-1 rows of usable slack, and an extra
        # tile would grow every shard's probe scan.
        slack = max(64, int(0.04 * max(per, 1)))
        cap_shard = round_up(max(per, 1) + slack, IVF_BN)
        n_tiles = cap_shard // IVF_BN
        nlist_pad = round_up(nlist + 1, 8)

        if i8_only:
            post_np = np.zeros((nshards * cap_shard, dim), dtype=np.int8)
            # Shards with zero built rows keep this default scale. It must
            # be the quantizer's zero-column floor (1e-30/127), NOT 1.0: a
            # later append routed to a never-built owner shard requantizes
            # against these scales, and with 1.0 a unit-norm row rints to
            # ~all-zero codes WITHOUT clipping — invisible to selection,
            # yet the clip guard never trips. With the floor scale the
            # append clips ~100% of components, the guard refuses, and the
            # fallback full rebuild derives real scales (the same
            # self-heal the classic layout gets from its ~1e-32 empty
            # scales). r5 review finding.
            cs_np = np.full(
                (nshards, dim), np.float32(1e-30 / 127.0), dtype=np.float32
            )
            vecs_np = None
        else:
            if storage_dtype in (None, "float32"):
                np_dtype = np.dtype(Float)
            else:
                import ml_dtypes  # ships with jax

                np_dtype = np.dtype(getattr(ml_dtypes, storage_dtype))
            vecs_np = np.zeros((nshards * cap_shard, dim), dtype=np_dtype)
        slots_np = np.full(nshards * cap_shard, -1, dtype=np.int32)
        act_np = np.zeros(nshards * cap_shard, dtype=bool)
        segs_np = np.zeros((nshards, nlist + 2), dtype=np.int32)
        c2t_np = np.zeros((nshards, nlist_pad, n_tiles), dtype=Float)
        row_cluster_np = np.full(nshards * cap_shard, nlist, dtype=np.int32)
        n_used = np.zeros(nshards, dtype=np.int64)
        s2r = np.full(
            int(act_rows.max()) + 1 if n_active else 1, -1, dtype=np.int64
        )

        for s in range(nshards):
            sel_s = shard_sel[s]
            local_rows = act_rows[sel_s]  # global engine slots of this shard
            local_assign = assign[sel_s]
            order = np.argsort(local_assign, kind="stable")
            sorted_clusters = local_assign[order]
            n_local = local_rows.shape[0]
            base = s * cap_shard
            if i8_only:
                # per-shard column-scaled int8 postings (selection only;
                # the rescore reads the engine corpus) — same math as
                # ops/quant.quantize_cols_i8, host-side
                rows_f = host_vectors[local_rows[order]].astype(
                    np.float32, copy=False
                )
                if n_local:
                    cs = np.maximum(np.abs(rows_f).max(axis=0), 1e-30) / 127.0
                    cs_np[s] = cs
                    post_np[base : base + n_local] = np.clip(
                        np.rint(rows_f / cs), -127, 127
                    ).astype(np.int8)
                # LOCAL corpus-shard row ids (see __init__)
                slots_np[base : base + n_local] = (
                    local_rows[order] - s * shard_rows_corpus
                ).astype(np.int32)
            else:
                vecs_np[base : base + n_local] = host_vectors[
                    local_rows[order]
                ].astype(np_dtype, copy=False)
                slots_np[base : base + n_local] = local_rows[order].astype(
                    np.int32
                )
            act_np[base : base + n_local] = True
            row_cluster_np[base : base + n_local] = sorted_clusters
            n_used[s] = n_local
            s2r[local_rows[order]] = base + np.arange(n_local)
            starts = np.searchsorted(sorted_clusters, np.arange(nlist + 1))
            segs_np[s] = np.concatenate([starts, [cap_shard]]).astype(
                np.int32
            )
            local_cluster = np.full(cap_shard, nlist, dtype=np.int64)
            local_cluster[:n_local] = sorted_clusters
            c2t_np[s][local_cluster, np.arange(cap_shard) // IVF_BN] = 1.0
            c2t_np[s][nlist] = 0.0  # pad bucket probes nothing

        cent_np = np.zeros((nlist_pad, dim), dtype=Float)
        cent_np[:nlist] = centroids

        row_sh = NamedSharding(mesh, P(shard_axis, None))
        vec_sh = NamedSharding(mesh, P(shard_axis))
        rep = NamedSharding(mesh, P())
        idx = cls(
            centroids=jax.device_put(cent_np, rep),
            vectors=(
                None if i8_only else jax.device_put(vecs_np, row_sh)
            ),
            slots=jax.device_put(slots_np, vec_sh),
            active=jax.device_put(act_np, vec_sh),
            seg_starts=jax.device_put(segs_np, row_sh),
            cluster2tile=jax.device_put(
                c2t_np, NamedSharding(mesh, P(shard_axis, None, None))
            ),
            nlist=nlist,
            n_tiles=n_tiles,
            cap_shard=cap_shard,
            dim=dim,
            mesh=mesh,
            shard_axis=shard_axis,
            vectors_i8c=(
                jax.device_put(post_np, row_sh) if i8_only else None
            ),
            cscale=(
                jax.device_put(cs_np, row_sh) if i8_only else None
            ),
            corpus_cap=corpus_cap if i8_only else None,
        )
        idx._host_blob = {
            "centroids": cent_np[:nlist],
            "assign_rows": act_rows.astype(np.int64),
            "assign_cluster": assign.astype(np.int32),
            "nlist": np.asarray(nlist),
        }
        # incremental-update bookkeeping (both layouts; see `update`)
        idx._slot2row = s2r
        idx._n_used = n_used
        idx._n_build = int(n_used.sum())
        idx._row_cluster_np = row_cluster_np
        if i8_only:
            # frozen build-time scales for requantize-on-append, and the
            # owner partition the slot->local-row mapping was built on
            idx._cscale_np = cs_np
            idx._shard_rows_corpus = shard_rows_corpus
        return idx

    # -- incremental maintenance -------------------------------------------

    @property
    def overflow_fraction(self) -> float:
        """Fraction of rows appended to the per-shard always-probed
        overflow regions since the last full build (dead holes count too —
        both grow the per-query scan until the next rebuild); 1.0 when the
        bookkeeping is absent (update disabled -> full-rebuild policy)."""
        if self._n_used is None:
            return 1.0
        used = max(1, int(self._n_used.sum()))
        return float(int(self._n_used.sum()) - self._n_build) / used

    def update(self, changed_slots, rows, active_flags) -> bool:
        """Apply a small mutation set in place; False = caller must rebuild.

        The sharded counterpart of IVFIndex.update: deletions/updates
        deactivate the old postings row; new/updated vectors append into
        per-shard overflow regions (cluster id = nlist, probed by every
        query on that shard). Classic layout: `slots` are global engine
        ids, so an appended row may live on ANY shard — appends fill the
        emptiest shards first to keep per-shard hot-tile counts balanced.
        int8-only layout: each row must land on its OWNING corpus shard
        (slot // per-shard corpus capacity — the rescore-locality
        invariant) and is requantized against the FROZEN build-time
        per-shard column scales; a clip-fraction guard (default 5% of
        components, `PICOVDB_IVF_I8_CLIP_MAX`) refuses the in-place path
        when new rows fall too far outside the build-time dynamic range —
        clip bias only lowers selection scores (the exact rescore re-reads
        the engine corpus), but extreme clipping could push a true winner
        out of the k_sel guard band. All device work is O(changed)
        scatters into the sharded arrays (GSPMD keeps them shard-local);
        no host corpus materialization, no k-means.
        """
        if self._n_used is None:
            return False
        i8_only = self.vectors is None
        changed_slots = np.asarray(changed_slots, dtype=np.int64)
        active_flags = np.asarray(active_flags, dtype=bool)
        n_new = int(active_flags.sum())
        nshards = self.seg_starts.shape[0]
        free = self.cap_shard - self._n_used  # (nshards,) overflow slack
        new_slots = changed_slots[active_flags]

        # --- placement (feasibility checked before any mutation) ----------
        new_rows = np.empty(n_new, dtype=np.int64)
        new_shard = np.empty(n_new, dtype=np.int64)
        take = np.zeros(nshards, dtype=np.int64)
        q8_new = None
        if i8_only:
            if n_new:
                # owner-constrained placement: local row ids gather from
                # the owning shard's corpus slice at rescore time
                new_shard[:] = new_slots // self._shard_rows_corpus
                if (new_shard >= nshards).any():
                    # slot beyond the built corpus capacity: the corpus
                    # was re-padded since the build (rows moved shards) —
                    # the whole layout is stale, rebuild
                    return False
                counts = np.bincount(new_shard, minlength=nshards)
                if (counts > free).any():
                    return False  # an owner shard's overflow is full
                # requantize against the frozen build-time scales
                rows_f = np.asarray(
                    rows[active_flags], dtype=np.float32
                )
                scaled = np.rint(
                    rows_f / self._cscale_np[new_shard]
                )
                clipped = float(
                    (np.abs(scaled) > 127).mean()
                ) if scaled.size else 0.0
                self.last_update_clip_fraction = clipped
                if clipped > _i8_clip_max():
                    return False
                q8_new = np.clip(scaled, -127, 127).astype(np.int8)
                fill = self._n_used.copy()
                for j in range(n_new):
                    s = int(new_shard[j])
                    new_rows[j] = s * self.cap_shard + int(fill[s])
                    fill[s] += 1
                take = counts.astype(np.int64)
        elif n_new:
            # emptiest-shard-first placement of the appended rows
            if n_new > int(free.sum()):
                return False
            remaining = n_new
            while remaining:
                order = np.argsort(-(free - take), kind="stable")
                s = order[0]
                grab = min(remaining, int(free[s] - take[s]))
                take[s] += grab
                remaining -= grab
            pos = 0
            for s in range(nshards):
                if not take[s]:
                    continue
                start = s * self.cap_shard + int(self._n_used[s])
                cnt = int(take[s])
                new_rows[pos : pos + cnt] = np.arange(start, start + cnt)
                new_shard[pos : pos + cnt] = s
                pos += cnt
        self._n_used += take

        # grow the slot map if the engine's slot table grew
        max_slot = int(changed_slots.max()) if changed_slots.size else 0
        if max_slot >= self._slot2row.shape[0]:
            grown = np.full(max_slot + 1, -1, dtype=np.int64)
            grown[: self._slot2row.shape[0]] = self._slot2row
            self._slot2row = grown

        old_rows = self._slot2row[changed_slots]
        old_rows = old_rows[old_rows >= 0]
        self._slot2row[changed_slots] = -1
        self._slot2row[new_slots] = new_rows
        self._blob_stale = True

        from ..ops.ivf import (
            _np_scalar,
            _pad_pow2,
            _scatter_rows_ivf,
            _scatter_set,
        )

        # scatter operands upload REPLICATED over the mesh (P()) — under
        # multi-process jax.distributed every process holds the identical
        # host mutation set, and a process-local (committed) array could
        # not join a jit over the globally sharded postings. Sizes pad to
        # power-of-two buckets (repeating the last entry — idempotent) so
        # epoch sizes share executables; see IVFIndex.update.
        rep = NamedSharding(self.mesh, P())
        store = self.vectors_i8c if i8_only else self.vectors
        mb = scatter_floor(int(store.shape[0]))
        if old_rows.size:
            self.active = _scatter_set(
                self.active,
                jax.device_put(
                    _pad_pow2(old_rows.astype(np.int32), mb), rep
                ),
                _np_scalar(False, bool),
            )
        if n_new:
            idx32 = jax.device_put(
                _pad_pow2(new_rows.astype(np.int32), mb), rep
            )
            if i8_only:
                self.vectors_i8c = _scatter_rows_ivf(
                    self.vectors_i8c, idx32,
                    jax.device_put(
                        _pad_pow2(np.ascontiguousarray(q8_new), mb), rep
                    ),
                )
                slot_vals = (
                    new_slots - new_shard * self._shard_rows_corpus
                ).astype(np.int32)
            else:
                self.vectors = _scatter_rows_ivf(
                    self.vectors, idx32,
                    jax.device_put(
                        _pad_pow2(np.ascontiguousarray(
                            rows[active_flags], dtype=Float
                        ), mb),
                        rep,
                    ),
                )
                slot_vals = new_slots.astype(np.int32)
            self.slots = _scatter_rows_ivf(
                self.slots, idx32,
                jax.device_put(_pad_pow2(slot_vals, mb), rep),
            )
            self.active = _scatter_set(
                self.active, idx32, _np_scalar(True, bool)
            )
            self._row_cluster_np[new_rows] = self.nlist
            # mark the overflow tiles hot in each owning shard's table:
            # cluster2tile is (nshards, nlist_pad, n_tiles) with tile ids
            # local to the shard
            local_tile = (new_rows - new_shard * self.cap_shard) // IVF_BN
            pairs = np.unique(
                np.stack([new_shard, local_tile], axis=1), axis=0
            )
            self.cluster2tile = _mark_overflow_tiles_sharded(
                self.cluster2tile,
                jax.device_put(_pad_pow2(pairs[:, 0].astype(np.int32)), rep),
                jax.device_put(_pad_pow2(pairs[:, 1].astype(np.int32)), rep),
                _np_scalar(self.nlist, np.int32),
                _np_scalar(1.0, np.float32),
            )
            if not i8_only and self.vectors_i8c is not None:
                # classic-layout mirror maintenance, O(changed): appended
                # rows requantize against the FROZEN per-shard column
                # scales under the same clip guard as the i8-only layout
                # (rather than re-deriving the whole per-shard mirror
                # every dirty epoch). A guard trip —
                # appends outside the built dynamic range — pays one full
                # re-derive with fresh scales; the mirror is
                # selection-only either way.
                rows_f = np.asarray(rows[active_flags], dtype=np.float32)
                scaled = (
                    np.rint(rows_f / self._cscale_np[new_shard])
                    if self._cscale_np is not None else None
                )
                clipped = (
                    float((np.abs(scaled) > 127).mean())
                    if scaled is not None and scaled.size else 0.0
                )
                self.last_update_clip_fraction = clipped
                if scaled is None or clipped > _i8_clip_max():
                    self.vectors_i8c, self.cscale = _quantize_shards_i8(
                        self.vectors, self.mesh, self.shard_axis
                    )
                    self._freeze_mirror_scales()
                else:
                    self.vectors_i8c = _scatter_rows_ivf(
                        self.vectors_i8c, idx32,
                        jax.device_put(_pad_pow2(
                            np.clip(scaled, -127, 127).astype(np.int8), mb
                        ), rep),
                    )
        return True

    def warm_update_path(self, bucket: int = 1024) -> None:
        """Pre-compile the incremental-update executables at this layout's
        shapes with IDENTITY writes on the live sharded buffers, mirroring
        `IVFIndex.warm_update_path` (see there and utils.scatter_bucket for
        the rationale: the first dirty epoch otherwise pays seconds of
        first-use XLA compiles at capacity shapes)."""
        from ..ops.ivf import _np_scalar, _scatter_rows_ivf, _scatter_set

        store = self.vectors_i8c if self.vectors is None else self.vectors
        if store is None:
            return
        rep = NamedSharding(self.mesh, P())
        idx = jax.device_put(np.zeros(bucket, dtype=np.int32), rep)
        # identity rows: fetch row 0 once, write it back `bucket` times —
        # int8 bytes on the i8-only layout, Float rows on the classic
        # layout (update() uploads f32; the jit casts to the mirror dtype)
        row0 = np.asarray(store[0:1])
        if self.vectors is not None:
            row0 = row0.astype(Float)
        row0 = np.repeat(row0, bucket, axis=0)
        rows_dev = jax.device_put(np.ascontiguousarray(row0), rep)
        if self.vectors is None:
            self.vectors_i8c = _scatter_rows_ivf(
                self.vectors_i8c, idx, rows_dev
            )
        else:
            self.vectors = _scatter_rows_ivf(self.vectors, idx, rows_dev)
            if self.vectors_i8c is not None:
                # classic mirror: O(changed) maintenance scatters int8
                m0 = np.asarray(self.vectors_i8c[0:1])
                self.vectors_i8c = _scatter_rows_ivf(
                    self.vectors_i8c, idx,
                    jax.device_put(np.repeat(m0, bucket, axis=0), rep),
                )
        slot0 = np.asarray(self.slots[0:1]).astype(np.int32)
        self.slots = _scatter_rows_ivf(
            self.slots, idx, jax.device_put(np.repeat(slot0, bucket), rep)
        )
        act0 = _np_scalar(np.asarray(self.active[0]), bool)
        self.active = _scatter_set(self.active, idx, act0)
        # cluster2tile identity: write cell (shard 0, nlist, tile 0)'s
        # current value back (the pairs operands pad at the default 8)
        zeros8 = jax.device_put(np.zeros(8, dtype=np.int32), rep)
        cur = _np_scalar(
            np.asarray(self.cluster2tile[0, self.nlist, 0]), np.float32
        )
        self.cluster2tile = _mark_overflow_tiles_sharded(
            self.cluster2tile, zeros8, zeros8,
            _np_scalar(self.nlist, np.int32), cur,
        )
        jax.block_until_ready(self.active)

    def to_blob(self) -> Optional[dict]:
        """Same sidecar schema as the single-device tier — stores built on a
        mesh reload into single-device processes and vice versa. After
        incremental updates the row/cluster lists refresh from the live
        bookkeeping so a reload reuses the trained centroids."""
        if self._host_blob is not None and self._blob_stale:
            live_slots = np.nonzero(self._slot2row >= 0)[0].astype(np.int64)
            self._host_blob = {
                "centroids": self._host_blob["centroids"],
                "assign_rows": live_slots,
                "assign_cluster": self._row_cluster_np[
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
        mesh=None,
        shard_axis: str = "shard",
        storage_dtype: Optional[str] = None,
        i8_only: bool = False,
        corpus_cap: Optional[int] = None,
    ) -> Optional["ShardedIVF"]:
        """Relayout from a persisted sidecar without retraining k-means."""
        try:
            cent = np.asarray(blob["centroids"], dtype=Float)
            if cent.ndim != 2 or cent.shape[1] != dim:
                return None
            size = host_vectors.shape[0]
            act_rows = np.nonzero(active_mask[:size])[0]
            saved = np.asarray(blob["assign_rows"])
            if act_rows.shape != saved.shape or not np.array_equal(
                act_rows, saved
            ):
                return None  # active set changed since save -> retrain
            return cls.build(
                host_vectors,
                active_mask,
                mesh,
                shard_axis=shard_axis,
                nlist=int(blob["nlist"]),
                dim=dim,
                warm_centroids=cent,
                iters=0,
                storage_dtype=storage_dtype,
                i8_only=i8_only,
                corpus_cap=corpus_cap,
            )
        except Exception:
            return None

    # -- search ------------------------------------------------------------

    def search(self, queries, k: int, ef: int, dev,
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Probed sharded top-k; host (vals, GLOBAL slot ids) of (Q, k)."""
        if self.vectors is None and dev.cap != self.corpus_cap:
            # int8-only layout laid out against a corpus capacity that has
            # since been re-padded (rows moved shards): the local row ids
            # are stale. Unreachable through the engine (mutations dirty
            # the store and every query-time rebuild precedes the search),
            # but self-heal to the exact sharded scan rather than serve
            # wrong rows.
            num_q = queries.shape[0]
            return dev.query(np.asarray(queries)[:num_q], k, None)
        vals, slot_ids, num_q = self.search_async(queries, k, ef, dev, nprobe)
        vals_np = np.asarray(vals)[:num_q, :k]
        slots_np = np.asarray(slot_ids)[:num_q, :k]
        if not np.isfinite(vals_np).any():
            # self-healing exact fallback, same contract as IVFIndex.search
            return dev.query(np.asarray(queries)[:num_q], k, None)
        return vals_np, slots_np

    def search_async(self, queries, k: int, ef: int, dev,
                     nprobe: Optional[int] = None):
        """Dispatch without blocking; same contract as IVFIndex.search_async."""
        if nprobe is None:
            nprobe = ef_to_nprobe(ef, self.nlist)
        nprobe = int(max(1, min(self.nlist, nprobe)))
        num_q = queries.shape[0]
        q_pad = max(8, next_pow2(num_q))
        if isinstance(queries, np.ndarray):
            if queries.dtype != Float and queries.dtype.itemsize > 2:
                queries = np.ascontiguousarray(queries, dtype=Float)
            if q_pad != num_q:
                buf = np.empty((q_pad, self.dim), dtype=queries.dtype)
                buf[:num_q] = queries
                buf[num_q:] = queries[0]  # duplicate probes are free
                queries = buf
            q_dev = jax.device_put(
                np.ascontiguousarray(queries),
                NamedSharding(self.mesh, P()),
            )
            if q_dev.dtype != jnp.float32:
                # compact query wire (engine._wire_encode): upload the
                # narrow batch, widen on device before the probe
                q_dev = q_dev.astype(jnp.float32)
        else:
            q_dev = queries.astype(jnp.float32)
            if q_pad != num_q:
                q_dev = jnp.pad(q_dev, ((0, q_pad - num_q), (0, 0)),
                                mode="edge")
            q_dev = jax.device_put(q_dev, NamedSharding(self.mesh, P()))
        # per-shard hot-grid bound and gather step, sized like the
        # single-device tier (ops/ivf.py hot_tile_bound / hot_tile_bytes)
        # from the store's per-device temporary budget
        g_tiles = hot_tile_bound(nprobe, self.nlist, self.n_tiles, q_pad)
        use_i8 = self.vectors_i8c is not None
        i8_only = self.vectors is None
        tile_step = budget_block(
            g_tiles,
            hot_tile_bytes(
                q_pad, self.dim,
                1 if (use_i8 or i8_only) else self.vectors.dtype.itemsize),
            temp_budget_of(dev),
        )
        if i8_only:
            corpus_scaled = dev.vstore_scale is not None
            corpus_i4 = getattr(dev, "storage_dtype", None) == "int4"
            fn = _make_sharded_ivf_search(
                id(self.mesh), self.mesh, self.shard_axis, k, nprobe,
                self.nlist, None, g_tiles, True,
                i8_only=True, corpus_scaled=corpus_scaled,
                k_sel=k + _ivf_guard(True, self.dim),
                corpus_i4=corpus_i4, tile_step=tile_step,
            )
            args = (
                q_dev, self.centroids, self.slots, self.seg_starts,
                self.active, self.cluster2tile, self.vectors_i8c,
                self.cscale, dev.vectors,
            )
            if corpus_scaled:
                args = args + (dev.vstore_scale,)
            with dispatch_slot_of(dev):
                vals, slot_ids = fn(*args)
            return vals, slot_ids, num_q
        fn = _make_sharded_ivf_search(
            id(self.mesh), self.mesh, self.shard_axis, k, nprobe, self.nlist,
            None if self.vectors.dtype == jnp.float32
            else str(self.vectors.dtype),
            g_tiles, use_i8,
            k_sel=k + _ivf_guard(use_i8, self.dim), tile_step=tile_step,
        )
        args = (q_dev, self.centroids, self.vectors, self.slots,
                self.seg_starts, self.active, self.cluster2tile)
        if use_i8:
            args = args + (self.vectors_i8c, self.cscale)
        with dispatch_slot_of(dev):
            vals, slot_ids = fn(*args)
        return vals, slot_ids, num_q


def _make_sharded_ivf_search(mesh_key, mesh, shard_axis: str, k: int,
                             nprobe: int, nlist: int,
                             compute_dtype_name: Optional[str],
                             g_tiles: int,
                             use_i8: bool = False, i8_only: bool = False,
                             corpus_scaled: bool = False,
                             k_sel: Optional[int] = None,
                             corpus_i4: bool = False,
                             tile_step: Optional[int] = None):
    key = (mesh_key, mesh.shape_tuple, shard_axis, k, nprobe, nlist,
           compute_dtype_name, g_tiles, use_i8, i8_only,
           corpus_scaled, k_sel, corpus_i4, tile_step)
    fn = _CACHE.get(key)
    if fn is None:
        fn = _build_sharded_ivf_search(
            mesh, shard_axis, k, nprobe, nlist, compute_dtype_name,
            g_tiles, use_i8, i8_only, corpus_scaled, k_sel,
            corpus_i4, tile_step,
        )
        while len(_CACHE) >= _CACHE_MAX:
            _CACHE.pop(next(iter(_CACHE)), None)
        _CACHE[key] = fn
    return fn


def _build_sharded_ivf_search(mesh, shard_axis, k, nprobe, nlist,
                              compute_dtype_name, g_tiles,
                              use_i8=False, i8_only=False,
                              corpus_scaled=False, k_sel=None,
                              corpus_i4=False, tile_step=None):
    # selection band incl. the guard — resolved by the CALLER via
    # _ivf_guard (env/dim policy before the cache; see ops/ivf.py)
    if k_sel is None:
        k_sel = k + (6 if (use_i8 or i8_only) else 4)
    compute_dtype = (
        jnp.dtype(compute_dtype_name) if compute_dtype_name else None
    )

    def local(q, cent, v, slots, segs, act, c2t, v8=None, cs=None):
        # block args carry the leading shard axis of size 1
        vals, slot_ids = probe_scan_local(
            q, cent, v, slots, segs[0], act, c2t[0],
            k=k, k_sel=k_sel, nprobe=nprobe, nlist=nlist, g_tiles=g_tiles,
            compute_dtype=compute_dtype,
            vectors_i8=v8, cscale=None if cs is None else cs[0],
            tile_step=tile_step,
        )
        return vals, slot_ids  # slots are global already — no base offset

    def local_i8only(q, cent, slots, segs, act, c2t, v8, cs, corpus,
                     *maybe_scale):
        # int8-only layout: `slots` hold LOCAL corpus-shard row ids and the
        # exact rescore gathers from this shard's slice of the engine
        # corpus (dequantized via its per-row scales when int8 STORAGE,
        # nibble-unpacked too when packed int4 STORAGE) — everything stays
        # shard-local until the final merge.
        vals, local_ids = probe_scan_local(
            q, cent, corpus, slots, segs[0], act, c2t[0],
            k=k, k_sel=k_sel, nprobe=nprobe, nlist=nlist, g_tiles=g_tiles,
            compute_dtype=None,
            vectors_i8=v8, cscale=cs[0],
            rescore_by_slot=True,
            rescore_scale=maybe_scale[0] if corpus_scaled else None,
            rescore_packed_i4=corpus_i4, tile_step=tile_step,
        )
        base = (
            jax.lax.axis_index(shard_axis) * corpus.shape[0]
        ).astype(jnp.int32)
        gids = jnp.where(local_ids >= 0, local_ids + base, jnp.int32(-1))
        return vals, gids

    if i8_only:
        in_specs = (P(), P(), P(shard_axis), P(shard_axis, None),
                    P(shard_axis), P(shard_axis, None, None),
                    P(shard_axis, None), P(shard_axis, None),
                    P(shard_axis, None))
        if corpus_scaled:
            in_specs = in_specs + (P(shard_axis),)
        body = local_i8only
    else:
        in_specs = (P(), P(), P(shard_axis, None), P(shard_axis),
                    P(shard_axis, None), P(shard_axis),
                    P(shard_axis, None, None))
        if use_i8:
            in_specs = in_specs + (P(shard_axis, None), P(shard_axis, None))
        body = local
    mapped = _shard_map(
        body,
        mesh=mesh,
        in_specs=in_specs,
        out_specs=(P(None, shard_axis), P(None, shard_axis)),
    )

    def merged(q, *arrays):
        from ..ops.exact import normalize_on_device

        q = normalize_on_device(q)
        vals, sids = mapped(q, *arrays)
        # (Q, nshards*k) candidate slabs -> final top-k across devices
        k_final = min(k, vals.shape[1])
        top_vals, order = jax.lax.top_k(vals, k_final)
        top_sids = jnp.take_along_axis(sids, order, axis=1)
        return top_vals, top_sids

    return jax.jit(merged)
