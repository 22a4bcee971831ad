"""PicoVectorDB — the public engine, on an accelerator.

Capability parity with the reference engine (picovdb/pico_vdb.py:97-1011):
upsert / query / query_one / get / get_all / get_by_id / delete / save /
flush / count / capacity / size / stats / vacuum / rebuild_index /
store_additional_data / get_additional_data / __len__, with the same record
keys, zero-vector→e0 normalization, md5 content IDs, insert/update report
dict, ValueError texts, DeprecationWarnings and PICOVDB_* env knobs.

Architecture (deliberately different from the reference — see SURVEY.md §7):
host state (ids, docs, id→slot map, free slots) is authoritative and guarded
by a reader-writer lock; the corpus matrix is mirrored into device memory as
a padded (cap, dim) array in the storage dtype + boolean active mask and
queried by one masked-top-k XLA program (the exact scan, the IVF probe, or
the shard_map multi-device path). Mutations mark the mirror dirty; the next query
synchronizes it lazily — scatter for small change sets, full re-upload for
large ones — governed by the same `faiss_incremental_threshold_ratio` knob
the reference uses for its incremental-vs-full FAISS rebuild decision
(picovdb/pico_vdb.py:884-921).

Known deviations from the reference (documented intentionally):
  * `capacity=` without `use_memmap=True` pre-allocates a fixed-capacity
    in-RAM store. (The reference makes that configuration unusable: any
    insert raises, picovdb/pico_vdb.py:441-442.)
  * Multi-key dict `where` filters mean AND. (The reference crashes on them
    by calling the dict, picovdb/pico_vdb.py:643-645.)
  * In memmap mode `save()` flushes the on-disk store in place instead of
    rewriting it through np.save (see picovdb_tpu/persistence.py docstring).
  * `vacuum()` compacts into an in-RAM array; a memmap store becomes RAM
    until the next `save()` (the reference has the same effect via fancy
    indexing, picovdb/pico_vdb.py:841).
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import time
import warnings
from typing import Any, Callable, Literal, Optional, Union

import numpy as np

from .constants import (
    ADAPTIVE_BUFFER,
    ARGSORT_THRESHOLD,
    ENV_ADAPTIVE_BUFFER,
    ENV_ARGSORT_THRESHOLD,
    ENV_COMPUTE_DTYPE,
    ENV_RESCORE,
    ENV_RESCORE_GUARD,
    ENV_RESCORE_MAX_Q,
    ENV_WRITER_PRIORITY,
    Float,
    RESCORE_GUARD,
    RESCORE_MAX_Q,
    ENV_QUERY_WIRE,
    QUERY_WIRE,
    QUERY_WIRE_MIN_Q,
    HNSW_EFC,
    HNSW_EFS,
    HNSW_M,
    K_ID,
    K_METRICS,
    K_VECTOR,
)
from .device import DeviceIndex
from .filters import TagIndex, compile_where_mask
from .locking import RWLock
from . import persistence
from .utils import (
    hash_vec,
    normalize_batch,
    per_device_bytes,
    timed,
    to_c_f32,
)

logger = logging.getLogger("picovdb_tpu")

WhereArg = Optional[Union[dict, Callable[[dict], bool]]]

# Where the persistent XLA compile cache lives when JAX_COMPILATION_CACHE_DIR
# is not set: one fixed path, because the path is part of the cache key and
# a directory that moves never hits. .gitignore lists it.
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def _maybe_enable_compile_cache() -> None:
    """Persistent XLA compile cache, so a restart or an index rebuild at an
    already-seen shape skips its compiles.

    With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and nothing is
    set here. Otherwise the cache goes to COMPILE_CACHE_DIR, unless the
    process already chose a directory.
    """
    if os.getenv("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    if jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)


class PicoVectorDB:
    """Cosine-only vector DB with metadata persistence, on an accelerator.

    Saves both a quick-load ids file and a full metadata file
    (`<base>.ids.json` + `<base>.meta.json`), keeps the corpus matrix
    resident in device memory for similarity search, and supports optional
    row-sharding across a device mesh.
    """

    def __init__(
        self,
        embedding_dim: int = 1024,
        metric: Literal["cosine"] = "cosine",
        storage_file: str = "picovdb",
        use_memmap: bool = False,
        capacity: Optional[int] = None,
        no_faiss: bool = False,
        faiss_threads: Optional[int] = None,
        # ANN-tier tunables, accepted for API compatibility with the
        # reference's FAISS HNSW knobs (picovdb/pico_vdb.py:114-121) and
        # mapped onto the IVF tier (hnsw_ef_search ~ nprobe scaling).
        hnsw_m: Optional[int] = None,
        hnsw_ef_construction: Optional[int] = None,
        ef_search_default: Optional[int] = None,
        hnsw_ef_search_default: Optional[int] = None,
        faiss_incremental_threshold_ratio: float = 0.2,
        # Top-k tuning knobs (kwarg -> env -> constant precedence,
        # reference: picovdb/pico_vdb.py:152-164).
        adaptive_buffer: Optional[int] = None,
        argsort_threshold: Optional[float] = None,
        # --- device knobs (new in this framework) ---
        device=None,
        mesh=None,
        shard_axis: str = "shard",
        compute_dtype: Optional[str] = None,
        storage_dtype: Optional[str] = None,
        scan_mode: Literal["auto", "xla", "approx"] = "auto",
        index: Literal["auto", "exact", "ivf"] = "auto",
        ivf_nlist: Optional[int] = None,
        ivf_nprobe: Optional[int] = None,
        writer_priority: Optional[bool] = None,
        rescore: Optional[Literal["auto", "host", "device"]] = None,
        query_wire: Optional[
            Literal["auto", "float32", "float16", "bfloat16"]
        ] = None,
    ) -> None:
        _maybe_enable_compile_cache()
        # Writer priority is opt-in; the default reproduces the reference's
        # no-priority semantics (picovdb/pico_vdb.py:1019-1063), under which
        # a saturated reader pool can starve writers (see locking.py).
        if writer_priority is None:
            wp_env = os.getenv(ENV_WRITER_PRIORITY)
            writer_priority = wp_env not in (None, "0", "false", "False", "")
        self._rwlock = RWLock(writer_priority=bool(writer_priority))
        self.dim = int(embedding_dim)
        self.metric = metric
        self._path = storage_file
        self._use_memmap = bool(use_memmap)
        self._capacity = capacity

        # host-authoritative parallel state ----------------------------------
        self._host_vectors: np.ndarray = np.empty((0, self.dim), dtype=Float)
        # Device-born ingestion (`ingest_device`) leaves the host matrix
        # unmaterialized; any path that reads the FULL matrix calls
        # `_ensure_host_vectors()` first, which pulls the corpus down once.
        # Row mutations on a lazy store do NOT materialize: they land in
        # `_host_overlay` (slot -> exact f32 row; zeros for deletions),
        # which the device sync scatters from and `_ensure_host_vectors`
        # merges — O(changed) host memory instead of an O(corpus)
        # device->host fetch per mutation epoch at the capacity tier.
        self._host_lazy: bool = False
        self._host_overlay: dict[int, np.ndarray] = {}
        self._ids: list[Optional[str]] = []
        self._docs: list[Optional[dict]] = []
        self._free: list[int] = []
        # id -> active slot map. `None` means "lazy": bulk ingest lanes
        # (ingest_device, the fresh upsert_columnar lane, load, vacuum)
        # skip building it — at 25M rows the dict costs ~1-2 us/insert
        # (~50 s) of pure CPython while queries never need it. The first
        # point lookup materializes it via the `_id2idx` property from
        # `_active_indices`, which is maintained eagerly and is the source
        # of truth for the active count.
        self._id2idx_store: Optional[dict[str, int]] = {}
        self._additional: dict[str, Any] = {}
        self._active_indices: np.ndarray = np.empty(0, dtype=np.int64)
        self._active_mask: np.ndarray = np.empty(0, dtype=bool)
        self._tag_index = TagIndex()
        self._ids_np: Optional[np.ndarray] = None  # lazy cache for query_columnar
        # Monotonic mutation counter keying the device-side filter-mask
        # cache (DeviceIndex._mask_cache): repeated dict-`where` queries
        # reuse one HBM-resident mask instead of re-uploading a (cap,)
        # bool array per query.
        self._filter_epoch: int = 0
        # Identity-keyed LRU for `ids=` prefilters: repeated queries with
        # the SAME ids list object skip the O(len(ids)) id->slot
        # translation AND (via the token in `_mask_key`) the device mask
        # upload. Entries hold a strong reference to the caller's ids
        # object, so the `is` check (not id()) is collision-free; the
        # token is monotonic so evicted entries can never alias a device
        # cache slot. Invalidation: `_filter_epoch` is part of the key.
        self._ids_mask_cache: list[dict] = []
        # itertools.count: next() is atomic under the GIL — a plain
        # read-then-increment let two concurrent readers mint the SAME
        # token, and the device mask cache (keyed on epoch+token) would
        # serve one ids list's mask for the other's queries (r5 review)
        self._ids_mask_token_counter = itertools.count()

        # knob resolution: kwarg -> env -> constant ---------------------------
        ab_env = os.getenv(ENV_ADAPTIVE_BUFFER)
        thr_env = os.getenv(ENV_ARGSORT_THRESHOLD)
        self._adaptive_buffer: int = (
            int(adaptive_buffer)
            if adaptive_buffer is not None
            else (int(ab_env) if ab_env is not None else ADAPTIVE_BUFFER)
        )
        # Accepted for introspection parity; the device top-k replaces the
        # argsort/argpartition choice (reference: picovdb/pico_vdb.py:698-713).
        self._argsort_threshold: float = (
            float(argsort_threshold)
            if argsort_threshold is not None
            else (float(thr_env) if thr_env is not None else ARGSORT_THRESHOLD)
        )
        cd_env = os.getenv(ENV_COMPUTE_DTYPE)
        if compute_dtype is None and cd_env:
            compute_dtype = cd_env

        # ANN knobs (stored resolved, reference: picovdb/pico_vdb.py:146-151)
        # hnsw_m / hnsw_ef_construction are live: they scale the IVF
        # build's partition count and k-means effort (_ivf_build_params),
        # the same knob-translation treatment ef_search got (-> nprobe).
        self._hnsw_m = int(hnsw_m) if hnsw_m is not None else HNSW_M
        self._hnsw_efc = (
            int(hnsw_ef_construction) if hnsw_ef_construction is not None else HNSW_EFC
        )
        if hnsw_ef_search_default is not None:
            self._ef_search = int(hnsw_ef_search_default)
        elif ef_search_default is not None:
            self._ef_search = int(ef_search_default)
        else:
            self._ef_search = HNSW_EFS
        # faiss_threads governed OpenMP in the reference; there is no host
        # thread pool here. Accepted (and env honored) for compatibility.
        _ = faiss_threads, os.getenv("PICOVDB_FAISS_THREADS")

        self._incr_threshold_ratio = float(faiss_incremental_threshold_ratio)
        self._index_kind = "exact" if no_faiss or index == "exact" else index

        # Host-f32 exact rescore for lossy storage dtypes (new; no reference
        # analog — the reference is f32-only). kwarg -> env -> "auto".
        if rescore is None:
            rescore = os.getenv(ENV_RESCORE) or "auto"
        if rescore not in ("auto", "host", "device"):
            raise ValueError(
                f"rescore must be 'auto', 'host' or 'device'; got {rescore!r}"
            )
        self._rescore_mode: str = rescore

        # Compact query wire for the batch serving lanes (constants.py
        # rationale). kwarg -> env -> "auto"; aliases accepted.
        if query_wire is None:
            query_wire = os.getenv(ENV_QUERY_WIRE) or QUERY_WIRE
        query_wire = {
            "f32": "float32", "off": "float32", "f16": "float16",
            "bf16": "bfloat16", "i8": "int8", "i16": "int16",
            "i8r": "int8_rescore",
        }.get(query_wire, query_wire)
        if query_wire not in (
            "auto", "float32", "int16", "float16", "bfloat16", "int8",
            "int8_rescore",
        ):
            raise ValueError(
                "query_wire must be 'auto', 'float32', 'int16', "
                "'float16', 'bfloat16', 'int8' or 'int8_rescore'; "
                f"got {query_wire!r}"
            )
        self._query_wire: str = query_wire
        # int8_rescore: candidates selected past top_k on the 1 B wire,
        # then exactly re-ranked on the host f32 rows (recall 1.0000 at
        # int8 wire cost; see query_batched). The guard is small because
        # wire noise only perturbs the QUERY once (~0.4% relative), unlike
        # storage noise: the true top-k sits within a few ranks.
        try:
            self._wire_guard: int = int(
                os.getenv("PICOVDB_WIRE_RESCORE_GUARD", "22")
            )
        except ValueError:
            self._wire_guard = 22

        rg_env = os.getenv(ENV_RESCORE_GUARD)
        if rg_env:
            self._rescore_guard: int = int(rg_env)
        elif storage_dtype == "int4":
            # int4's quantization noise (~18x int8's step) packs ~4x the
            # near-ties into the band: the default guard saturated most
            # random-corpus dispatches at 500k x 1024, each paying a
            # second full dispatch. A 4x default guard selects the wide
            # band up front.
            self._rescore_guard = 4 * RESCORE_GUARD
        else:
            self._rescore_guard = RESCORE_GUARD
        rq_env = os.getenv(ENV_RESCORE_MAX_Q)
        self._rescore_max_q: int = int(rq_env) if rq_env else RESCORE_MAX_Q
        # True once the host matrix was materialized from a lossy device
        # mirror (bf16/int8 device-born store): rescoring against such a
        # copy cannot recover f32 precision, so the rescore tier disables.
        self._host_f32_lossy: bool = False
        self._last_rescore: Optional[str] = None
        self._ivf_nlist = ivf_nlist
        # Construction point of the last IVF build (set by
        # _ivf_build_params; surfaced in last_query_debug()["ann"]).
        self._ann_build_params: Optional[dict] = None
        self._ivf_nprobe = ivf_nprobe
        self._ivf = None  # built lazily by the ANN tier (ops/ivf.py)
        # warm-centroid stash for rebuilds that had to free the live IVF
        # first (device grow at the HBM ceiling, _sync_device_locked)
        self._ivf_warm_blob = None

        # device mirror --------------------------------------------------------
        self._dev = DeviceIndex(
            self.dim,
            device=device,
            mesh=mesh,
            shard_axis=shard_axis,
            compute_dtype=compute_dtype,
            storage_dtype=storage_dtype,
            scan_mode=scan_mode,
        )

        # dirty tracking (device mirror out of sync with host state)
        self._dirty: bool = False
        self._pending_add: set[int] = set()
        self._pending_remove: set[int] = set()
        self._pending_full: bool = False  # force a full mirror re-upload

        # introspection (reference analogs: _last_topk_strategy/_last_k_eff
        # picovdb/pico_vdb.py:165-167, _last_faiss_rebuild_mode :203-204)
        self._last_topk_strategy: Optional[str] = None
        self._last_k_eff: Optional[int] = None
        # count of exact re-serves after an IVF probe found every probed
        # cluster empty (stale centroids / tiny nprobe)
        self._exact_retries: int = 0
        # queries whose rescore guard band saturated and re-dispatched
        # wider (see _rescored_dispatch)
        self._rescore_escalations: int = 0
        self._last_sync_mode: Optional[str] = None
        # "incremental" | "full" | None — analog of the reference's
        # `_last_faiss_rebuild_mode` (picovdb/pico_vdb.py:203-204, 905, 921)
        self._last_ann_rebuild_mode: Optional[str] = None

        self._load_or_init()

    # ------------------------------------------------------------------
    # id -> slot map (lazy)
    # ------------------------------------------------------------------

    @property
    def _id2idx(self) -> dict[str, int]:
        """Materialize the id -> active-slot map on first point lookup.

        `_active_indices` + `_ids` always carry the same information
        (for every active slot i, `_ids[i]` is its live id), so bulk
        lanes leave the dict unbuilt and counting/serving never pays for
        it. Concurrent readers may race the build; both produce the same
        dict and the last assignment wins, which is benign.
        """
        m = self._id2idx_store
        if m is None:
            ids = self._ids
            m = {ids[i]: i for i in self._active_indices.tolist()}
            self._id2idx_store = m
        return m

    @_id2idx.setter
    def _id2idx(self, value: Optional[dict[str, int]]) -> None:
        self._id2idx_store = value

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------

    @timed("load")
    def _load_or_init(self) -> None:
        qinfo = (
            persistence.load_quantized(self._path)
            if persistence.exists(self._path) else None
        )
        if qinfo is not None:
            self._load_quantized(qinfo)
            return
        if self._is_multiprocess() and persistence.exists(self._path):
            self._load_distributed()
            return
        if persistence.exists(self._path):
            logger.info("Loading existing DB …")
            self._ids = persistence.load_ids(self._path)
            count = len(self._ids)
            self._host_vectors = persistence.load_vectors(
                self._path, count, self.dim, self._use_memmap
            )
            if (
                self._host_vectors.ndim != 2
                or self._host_vectors.shape[1] != self.dim
            ):
                raise ValueError(
                    f"stored vectors have shape {self._host_vectors.shape}; "
                    f"expected (*, {self.dim}) — wrong embedding_dim for this "
                    f"store?"
                )
            self._docs, self._additional = persistence.load_meta(self._path, count)
            if len(self._docs) < count:
                self._docs = list(self._docs) + [None] * (count - len(self._docs))
            free_append = self._free.append
            actives: list[int] = []
            actives_append = actives.append
            for i, (_id, doc) in enumerate(zip(self._ids, self._docs)):
                if doc is None:
                    free_append(i)
                elif _id is not None:
                    actives_append(i)
            self._id2idx = None  # lazy: built on first point lookup
            self._active_mask = np.zeros(count, dtype=bool)
            if actives:
                self._active_indices = np.asarray(actives, dtype=np.int64)
                self._active_mask[self._active_indices] = True
            else:
                self._active_indices = np.empty(0, dtype=np.int64)
            self._tag_index.resize(count)
            # Eager device upload mirrors the reference's FAISS
            # load-or-rebuild in the constructor (picovdb/pico_vdb.py:260-283).
            if self._active_indices.size:
                self._dev.full_upload(self._host_vectors, self._active_mask)
                self._last_sync_mode = "full"
            # ANN sidecar: reuse the persisted index when it still matches,
            # else retrain (the reference's read_index-or-rebuild behavior,
            # picovdb/pico_vdb.py:260-283).
            if self._index_kind != "exact" and self._active_indices.size:
                blob = persistence.load_ann(self._path)
                if blob is not None:
                    try:
                        if self._dev.mesh is not None:
                            from .parallel.ivf_mesh import ShardedIVF

                            i8o = self._ivf_i8_only()
                            self._ivf = ShardedIVF.from_blob(
                                blob, np.asarray(self._host_vectors),
                                self._active_mask, self.dim,
                                mesh=self._dev.mesh,
                                shard_axis=self._dev.shard_axis,
                                storage_dtype=self._dev.storage_dtype,
                                i8_only=i8o,
                                corpus_cap=self._dev.cap if i8o else None,
                            )
                        else:
                            from .ops.ivf import IVFIndex

                            self._ivf = IVFIndex.from_blob(
                                blob, np.asarray(self._host_vectors),
                                self._active_mask, self.dim,
                                dev_vectors=self._dev.vectors,
                                storage_dtype=self._dev.storage_dtype,
                                i8_only=self._ivf_i8_only(),
                                dequant_scale=self._dev.vstore_scale,
                            )
                    except Exception:
                        self._ivf = None
                if self._ivf is None and self._index_kind == "ivf":
                    logger.warning(
                        "ANN sidecar missing or stale; rebuilding"
                    )
                    self._rebuild_ann()
            self._dirty = False
            logger.info(
                "Loaded %d active / %d total vectors",
                int(self._active_indices.size), count
            )
        else:
            if self._capacity is not None:
                cap = int(self._capacity)
                if self._use_memmap:
                    self._host_vectors = persistence.create_memmap(
                        self._path, cap, self.dim
                    )
                else:
                    self._host_vectors = np.zeros((cap, self.dim), dtype=Float)
                self._ids = [None] * cap
                self._docs = [None] * cap
                self._free = list(range(cap))
                self._active_mask = np.zeros(cap, dtype=bool)
                self._tag_index.resize(cap)
            else:
                self._ids, self._docs = [], []
                self._host_vectors = np.empty((0, self.dim), dtype=Float)
                self._active_mask = np.empty(0, dtype=bool)
            self._active_indices = np.empty(0, dtype=np.int64)
            logger.info("No persisted data – fresh DB")
            self._dirty = False

    def _is_multiprocess(self) -> bool:
        """True when this engine is one process of a multi-controller
        (jax.distributed) program over a global mesh. Every process must
        then issue the SAME queries/mutations in the same order — the
        standard SPMD contract; jits over the sharded corpus are
        collective programs."""
        if self._dev.mesh is None:
            return False
        import jax

        return jax.process_count() > 1

    def _load_distributed(self) -> None:
        """Construct one logical store across processes.

        Each process reads ONLY its own shard of a `save(shards=N)`
        checkpoint (N == process_count), joins the global row-sharded
        corpus (parallel.multihost.load_host_shard), and adopts it on
        device — padding/resharding runs as one GSPMD program, so no host
        ever holds the full matrix. Host metadata (ids/docs: JSON, small)
        loads replicated on every process; the store comes back LAZY, and
        mutations flow through the overlay + replicated-operand scatters
        exactly like a device-born store. float32/bfloat16 storage;
        index="ivf" is not yet served here (ShardedIVF's build is
        host-fed) — the engine warns and serves exact.
        """
        import jax

        from .parallel.multihost import load_host_shard

        paths = persistence.find_shards(self._path)
        nproc = jax.process_count()
        if len(paths) != nproc:
            raise ValueError(
                f"multi-process load needs a save(shards={nproc}) layout; "
                f"found {len(paths)} shard files for {self._path!r}"
            )
        logger.info("Loading existing DB (distributed, %d processes) …",
                    nproc)
        self._ids = persistence.load_ids(self._path)
        count = len(self._ids)
        self._docs, self._additional = persistence.load_meta(
            self._path, count
        )
        if len(self._docs) < count:
            self._docs = list(self._docs) + [None] * (count - len(self._docs))
        free_append = self._free.append
        actives: list[int] = []
        for i, (_id, doc) in enumerate(zip(self._ids, self._docs)):
            if doc is None:
                free_append(i)
            elif _id is not None:
                actives.append(i)
        self._id2idx = None
        self._active_mask = np.zeros(count, dtype=bool)
        if actives:
            self._active_indices = np.asarray(actives, dtype=np.int64)
            self._active_mask[self._active_indices] = True
        else:
            self._active_indices = np.empty(0, dtype=np.int64)
        self._tag_index.resize(count)
        self._host_vectors = None
        self._host_lazy = True
        if count:
            v_glob = load_host_shard(
                self._path, self.dim, self._dev.mesh,
                shard_axis=self._dev.shard_axis,
            )
            # load_host_shard may pad rows up to device alignment (odd
            # counts aren't row-shardable otherwise); the pad rows are
            # zeros and the active mask marks them False below
            if v_glob.shape[0] < count:
                raise ValueError(
                    f"shard files hold {v_glob.shape[0]} rows but the ids "
                    f"file has {count} slots"
                )
            self._dev.adopt_global(v_glob, self._active_mask)
            self._last_sync_mode = "full"
        if self._index_kind == "ivf":
            logger.warning(
                "index='ivf' is not yet served on multi-process engines "
                "(the sharded build is host-fed); serving exact"
            )
            self._index_kind = "exact"
        self._dirty = False
        logger.info(
            "Loaded %d active / %d total vectors (process %d/%d)",
            int(self._active_indices.size), count,
            jax.process_index(), nproc,
        )

    def _load_quantized(self, q: dict) -> None:
        """Reconstruct a store from its quantized checkpoint (packed plane +
        per-row scales, persistence.save_quantized_atomic). The store comes
        back LAZY — exactly the state a device-born quantized store lives
        in: the corpus streams host-disk -> HBM chunk by chunk and the f32
        matrix never exists on either side (an 8M x 1024 int4
        reload would otherwise materialize ~32.8 GB). Exact overlay
        rows (mutations made while lazy before the save) are restored.
        """
        sd = self._dev.storage_dtype
        if sd != q["storage_dtype"]:
            raise ValueError(
                f"store at {self._path!r} was saved with storage_dtype="
                f"{q['storage_dtype']!r}; construct PicoVectorDB with "
                f"storage_dtype={q['storage_dtype']!r} (got {sd!r})"
            )
        if q["dim"] != self.dim:
            raise ValueError(
                f"quantized store has dim {q['dim']}; expected {self.dim} — "
                "wrong embedding_dim for this store?"
            )
        if self._use_memmap:
            raise ValueError(
                "use_memmap does not apply to quantized stores: the packed "
                "plane itself loads memmapped and streams to the device"
            )
        logger.info("Loading existing DB (quantized %s plane) …", sd)
        self._ids = persistence.load_ids(self._path)
        count = len(self._ids)
        if count != q["rows"]:
            raise ValueError(
                f"ids file has {count} slots but the quantized plane has "
                f"{q['rows']} rows — mismatched checkpoint generation"
            )
        self._docs, self._additional = persistence.load_meta(
            self._path, count
        )
        if len(self._docs) < count:
            self._docs = list(self._docs) + [None] * (count - len(self._docs))
        free_append = self._free.append
        actives: list[int] = []
        actives_append = actives.append
        for i, (_id, doc) in enumerate(zip(self._ids, self._docs)):
            if doc is None:
                free_append(i)
            elif _id is not None:
                actives_append(i)
        self._id2idx = None  # lazy: built on first point lookup
        self._active_mask = np.zeros(count, dtype=bool)
        if actives:
            self._active_indices = np.asarray(actives, dtype=np.int64)
            self._active_mask[self._active_indices] = True
        else:
            self._active_indices = np.empty(0, dtype=np.int64)
        self._tag_index.resize(count)
        self._host_vectors = None
        self._host_lazy = True
        self._host_overlay = dict(q["overlay"])
        if count:
            self._dev.upload_prequantized(
                q["plane"], q["scales"], self._active_mask
            )
            self._last_sync_mode = "full"
        # ANN sidecar: rebuild from the device corpus (the i8-only layout
        # the quantized tiers use trains straight off the resident plane —
        # no host materialization). Mesh stores rebuild lazily instead:
        # ShardedIVF's build path is host-fed.
        if (
            self._index_kind != "exact"
            and self._active_indices.size
            and self._dev.mesh is None
        ):
            blob = persistence.load_ann(self._path)
            if blob is not None:
                try:
                    from .ops.ivf import IVFIndex

                    self._ivf = IVFIndex.from_blob(
                        blob, None, self._active_mask, self.dim,
                        dev_vectors=self._dev.vectors,
                        storage_dtype=sd,
                        i8_only=self._ivf_i8_only(),
                        dequant_scale=self._dev.vstore_scale,
                    )
                except Exception:
                    self._ivf = None
            if self._ivf is None and self._index_kind == "ivf":
                logger.warning("ANN sidecar missing or stale; rebuilding")
                self._rebuild_ann()
        self._dirty = self._index_kind == "ivf" and self._ivf is None
        logger.info(
            "Loaded %d active / %d total vectors (quantized)",
            int(self._active_indices.size), count,
        )

    def size(self) -> int:
        """Deprecated: returns total slots (including deleted placeholders)."""
        warnings.warn(
            "size() is deprecated: use count() for active items; "
            "capacity() returns total slots.",
            DeprecationWarning,
            stacklevel=2,
        )
        with self._rwlock.read_lock():
            return len(self._ids)

    def capacity(self) -> int:
        """Total slots including deleted placeholders (`count()` for active)."""
        with self._rwlock.read_lock():
            return len(self._ids)

    def count(self) -> int:
        """Number of active (non-deleted) items."""
        with self._rwlock.read_lock():
            return int(self._active_indices.size)

    def __len__(self) -> int:
        with self._rwlock.read_lock():
            return int(self._active_indices.size)

    @timed("save")
    def save(
        self, shards: Optional[int] = None,
        quantized: Optional[bool] = None,
    ) -> None:
        """Persist atomically (tmp files + os.replace), overwriting existing.

        `shards=N` writes the matrix as N row-contiguous files (multi-host
        layout, new in this framework); default keeps the reference's
        single-file format. Loading auto-detects either.

        `quantized=True` (int8/int4 stores only) writes the packed storage
        plane + per-row scales instead of an f32 matrix, streamed device ->
        disk chunk by chunk — a capacity-tier store checkpoints in bounded
        host RAM instead of materializing the f32 corpus (~32.8 GB at
        8M x 1024 int4). Default None auto-engages that path on lazy
        (device-born) quantized stores whose f32 matrix would exceed
        PICOVDB_QSAVE_AUTO_GB (default 2 GB); `quantized=False` forces the
        reference-compatible f32 format. Loading auto-detects the format.
        """
        with self._rwlock.write_lock():
            if self._dirty:
                self._sync_device_locked()
            if self._is_multiprocess():
                if quantized:
                    logger.warning(
                        "save(quantized=True) is single-process only; "
                        "the multi-process checkpoint writes dequantized "
                        "f32 shards instead"
                    )
                self._save_distributed(shards)
                return
            if self._quantized_save_applies(quantized, shards):
                n = len(self._ids)
                persistence.save_quantized_atomic(
                    self._path,
                    self._ids,
                    self._docs,
                    self._additional,
                    self._dev.iter_store_chunks(n),
                    n,
                    self.dim // 2 if self._dev.storage_dtype == "int4"
                    else self.dim,
                    self._dev.storage_dtype,
                    self.dim,
                    overlay=self._host_overlay if self._host_lazy else None,
                    ann_blob=(
                        self._ivf.to_blob() if self._ivf is not None else None
                    ),
                )
                return
            self._ensure_host_vectors()
            if (
                shards is not None
                and shards > 1
                and isinstance(self._host_vectors, np.memmap)
            ):
                # A sharded save replaces the single-file matrix; converting
                # first keeps the live store from writing to an unlinked
                # inode (POSIX) or failing the remove (Windows). Memmap mode
                # ends here — documented deviation.
                logger.warning(
                    "Sharded save converts a memmapped store to an in-memory "
                    "array; memmap mode ends for this instance."
                )
                self._host_vectors = np.array(self._host_vectors)
                self._use_memmap = False
            ann_blob = self._ivf.to_blob() if self._ivf is not None else None
            persistence.save_atomic(
                self._path,
                self._ids,
                self._docs,
                self._additional,
                self._host_vectors,
                self.dim,
                ann_blob=ann_blob,
                n_shards=shards,
            )

    def _save_distributed(self, shards: Optional[int]) -> None:
        """Persist a multi-process store: one vector shard file per
        process, metadata from process 0 (caller holds the write lock,
        device mirror synced).

        Every process executes the same sequence of replicated-output
        slice programs (the SPMD contract — per-file row ranges are
        identical constants on all processes, so the jits match); the
        owning process fetches its replica locally and writes its file
        atomically. A barrier closes the save so no process returns
        before the checkpoint is complete on shared storage.
        """
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P

        nproc = jax.process_count()
        pid = jax.process_index()
        if shards is not None and shards != nproc:
            raise ValueError(
                f"multi-process save writes one shard per process "
                f"({nproc}); got shards={shards}"
            )
        n = len(self._ids)
        # device-aligned split (persistence.shard_split_rows): non-last
        # shards must divide evenly across a loading process's local
        # devices so the loader can tail-pad only the LAST block
        per = persistence.shard_split_rows(n, nproc)
        rep = NamedSharding(self._dev.mesh, P())
        sdt = self._dev.storage_dtype
        scales = self._dev.vstore_scale
        quantized = sdt in ("int8", "int4") and scales is not None
        for f in range(nproc):
            start, stop = f * per, min(n, (f + 1) * per)
            if stop <= start:
                # the aligned split can leave tail shards empty; still
                # write a (0, dim) file — the loader requires one file
                # per process
                if pid == f:
                    persistence.save_shard_atomic(
                        self._path, f, nproc,
                        np.zeros((0, self.dim), dtype=np.float32),
                    )
                continue  # identical on every process: no jit skew
            if quantized:
                # the resident plane holds quantization CODES (int8, or
                # int4 nibble-packed (cap, dim//2)); shard files are
                # f32, so dequantize in the slice program — writing the
                # raw codes cast to f32 would double-quantize on reload
                # (and mis-shape int4 outright). The quantized on-disk
                # format (save(quantized=True)) is single-process only.
                def _slice_dq(v, sc, s=start, m=stop - start):
                    from .ops.quant import unpack_i4

                    vs = jax.lax.dynamic_slice_in_dim(v, s, m, 0)
                    ss = jax.lax.dynamic_slice_in_dim(sc, s, m, 0)
                    full = (unpack_i4(vs) if sdt == "int4" else vs
                            ).astype(jnp.float32)
                    return full * ss[:, None]

                sliced = jax.jit(_slice_dq, out_shardings=rep)(
                    self._dev.vectors, scales
                )
            else:
                sliced = jax.jit(
                    lambda v, s=start, m=stop - start: jax.lax.
                    dynamic_slice_in_dim(v, s, m, 0).astype(jnp.float32),
                    out_shardings=rep,
                )(self._dev.vectors)
            if pid == f:
                persistence.save_shard_atomic(
                    self._path, f, nproc, np.asarray(sliced)
                )
            else:
                jax.block_until_ready(sliced)
            del sliced
        if pid == 0:
            persistence.save_ids_meta_atomic(
                self._path, self._ids, self._docs, self._additional,
                self.dim,
                ann_blob=(
                    self._ivf.to_blob() if self._ivf is not None else None
                ),
            )
            vfile = persistence.vecs_path(self._path)
            if os.path.exists(vfile):
                os.remove(vfile)  # stale single-file matrix
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("picovdb_save_distributed")
        logger.info("Saved %d vectors (distributed, shard %d/%d)",
                    n, pid, nproc)

    def _quantized_save_applies(
        self, quantized: Optional[bool], shards: Optional[int]
    ) -> bool:
        """Resolve the save format (see `save`). Caller holds the write
        lock and has synced the device mirror, so when this returns True
        the resident plane is the authoritative corpus."""
        sd = self._dev.storage_dtype
        if quantized is False:
            return False
        if shards is not None and shards > 1:
            if quantized:
                raise ValueError(
                    "quantized save does not compose with shards=N; the "
                    "plane is one file (load streams it chunk by chunk)"
                )
            return False
        if quantized:
            if sd not in ("int8", "int4"):
                raise ValueError(
                    "quantized save requires int8/int4 storage; this "
                    f"store is {sd or 'float32'!r}"
                )
            return self._dev.vectors is not None and len(self._ids) > 0
        # auto: a lazy (device-born) quantized store whose f32
        # materialization would be capacity-hostile
        if sd not in ("int8", "int4") or not self._host_lazy:
            return False
        if self._dev.vectors is None or not self._ids:
            return False
        try:
            auto_gb = float(os.getenv("PICOVDB_QSAVE_AUTO_GB", "2") or 2)
        except ValueError:
            auto_gb = 2.0
        return len(self._ids) * self.dim * 4.0 > auto_gb * 2**30

    def flush(self) -> None:
        """If using memmap, flush changes to disk. No-op otherwise."""
        with self._rwlock.read_lock():
            if self._use_memmap and isinstance(self._host_vectors, np.memmap):
                self._host_vectors.flush()

    # ------------------------------------------------------------------
    # Mutators
    # ------------------------------------------------------------------

    def upsert(self, items: list[dict[str, Any]]) -> dict[str, list[str]]:
        """Insert or update items; returns {"update": [...], "insert": [...]}.

        Each item carries `_vector_` (1-D, length dim) plus arbitrary
        metadata; `_id_` defaults to the md5 of the normalized vector bytes
        (reference: picovdb/pico_vdb.py:403-498).
        """
        with self._rwlock.write_lock():
            report: dict[str, list[str]] = {"update": [], "insert": []}
            if not items:
                return report
            # Lazy (device-born) stores mutate through the overlay — no
            # corpus materialization (`_write_host_row`).
            # Pass 1: validate into one preallocated (n, dim) buffer, then
            # normalize as a single vectorized batch. (The reference
            # normalizes per item in Python, picovdb/pico_vdb.py:412-422;
            # np.stack over 100k tiny arrays costs ~10 s on one core, row
            # assignment into a buffer ~0.3 s.)
            buf = np.empty((len(items), self.dim), dtype=Float)
            for j, item in enumerate(items):
                vec_raw = np.asarray(item[K_VECTOR], dtype=Float)
                if vec_raw.ndim != 1:
                    raise ValueError(
                        f"upsert vector must be 1D with length {self.dim}; "
                        f"got shape {tuple(vec_raw.shape)}"
                    )
                if vec_raw.shape[0] != self.dim:
                    raise ValueError(
                        f"upsert vector dim mismatch: expected {self.dim}, "
                        f"got {vec_raw.shape[0]}"
                    )
                buf[j] = vec_raw
            norm = normalize_batch(buf)

            # Resolve ids + metadata columns, then run the one shared
            # insert/update state machine (`_upsert_rows`).
            item_ids: list[str] = []
            metas: list[dict] = []
            for j, item in enumerate(items):
                meta = {k: v for k, v in item.items() if k != K_VECTOR}
                iid = meta.get(K_ID)
                iid = iid if iid is not None else hash_vec(norm[j])
                meta[K_ID] = iid
                item_ids.append(iid)
                metas.append(meta)
            return self._upsert_rows(norm, item_ids, metas)

    def upsert_columnar(
        self,
        vectors: np.ndarray,
        ids: Optional[list[str]] = None,
        metadata: Optional[list[Optional[dict]]] = None,
        copy: bool = True,
    ) -> dict[str, list[str]]:
        """Bulk upsert from columnar inputs: one (n, dim) matrix + optional
        parallel `ids` / `metadata` lists.

        Same semantics as `upsert` (update on known ID, free-slot reuse,
        append, capacity ValueError, md5 auto-IDs, last-duplicate-wins) but
        without per-item dict traversal — the bulk-load fast lane replacing
        the reference's per-item Python loop (picovdb/pico_vdb.py:403-498),
        which is the difference between ~20k and >200k vec/s host-side.

        `copy=False` normalizes the caller's matrix in place when it is
        already C-contiguous float32, and a fresh store adopts it as the
        backing array — zero extra (n, dim) allocations end to end. The
        caller must not mutate the matrix afterwards.
        """
        mat = np.asarray(vectors)
        if mat.ndim != 2 or mat.shape[1] != self.dim:
            raise ValueError(
                f"upsert_columnar expects a 2D array with last dim "
                f"{self.dim}; got shape {tuple(mat.shape)}"
            )
        n = mat.shape[0]
        if ids is not None and len(ids) != n:
            raise ValueError(
                f"ids length {len(ids)} != number of vectors {n}"
            )
        if metadata is not None and len(metadata) != n:
            raise ValueError(
                f"metadata length {len(metadata)} != number of vectors {n}"
            )
        if n == 0:
            return {"update": [], "insert": []}
        if copy:
            mat = np.array(mat, dtype=Float, order="C")
        norm = normalize_batch(mat, inplace=True)  # ascontiguousarray inside
        if ids is None:
            from .utils import hash_rows

            ids = hash_rows(norm)

        with self._rwlock.write_lock():
            report: dict[str, list[str]] = {"update": [], "insert": []}
            # ---- fresh-store fast lane: adopt columns wholesale ----------
            if (
                not self._ids
                and not self._free
                and self._capacity is None
                and len(set(ids)) == n
            ):
                self._host_vectors = norm
                self._ids = list(ids)
                if metadata is None:
                    self._docs = [{K_ID: _id} for _id in ids]
                else:
                    self._docs = [
                        {**(m or {}), K_ID: _id}
                        for m, _id in zip(metadata, ids)
                    ]
                self._id2idx = None  # lazy: built on first point lookup
                self._active_indices = np.arange(n, dtype=np.int64)
                self._active_mask = np.ones(n, dtype=bool)
                self._tag_index.resize(n)
                report["insert"] = list(ids)
                self._ids_np = None
                self._pending_full = True
                self._filter_epoch += 1
                self._dirty = True
                return report
            # ---- general lane: the shared state machine ------------------
            # (lazy stores mutate through the overlay, no materialization)
            if metadata is None:
                metas = [{K_ID: i} for i in ids]
            else:
                metas = [
                    {**(m or {}), K_ID: i} for m, i in zip(metadata, ids)
                ]
            return self._upsert_rows(norm, list(ids), metas)

    def _upsert_rows(
        self, norm: np.ndarray, item_ids: list[str], metas: list[dict]
    ) -> dict[str, list[str]]:
        """The insert/update state machine shared by `upsert` and
        `upsert_columnar` (caller holds the write lock, rows normalized).

        Semantics (reference: picovdb/pico_vdb.py:403-498): update in
        place for known ids, free-slot reuse, bulk append otherwise;
        in-batch duplicate ids redirect the pending row (last wins — the
        reference would IndexError, pico_vdb.py:429-431). Capacity is
        validated BEFORE any mutation: the reference raises mid-loop
        (pico_vdb.py:441-442) leaving earlier items partially applied;
        here a capacity ValueError leaves the store untouched (documented
        deviation — partial application would also desync the deferred
        active/tag/epoch bookkeeping done after the loop).
        """
        report: dict[str, list[str]] = {"update": [], "insert": []}
        n = len(item_ids)
        id2idx = self._id2idx
        if self._capacity is not None:
            fresh = {i for i in item_ids if i not in id2idx}
            if len(fresh) > len(self._free):
                raise ValueError("Database capacity exceeded")
        new_rows: list[int] = []  # rows of `norm` appended at the end
        new_ids: list[str] = []
        new_docs: list[dict] = []
        new_active: list[int] = []
        touched_idx: list[int] = []
        touched_docs: list[dict] = []
        pending_pos: dict[str, int] = {}  # id -> position in new_rows
        n_slots = len(self._ids)
        for j in range(n):
            item_id = item_ids[j]
            meta = metas[j]
            idx = id2idx.get(item_id)
            if idx is not None:
                if idx >= n_slots:
                    # duplicate id within this batch whose first occurrence
                    # is a pending append: redirect that pending row
                    # instead of writing out of bounds
                    pos = pending_pos[item_id]
                    new_rows[pos] = j
                    new_docs[pos] = meta
                else:
                    self._write_host_row(idx, norm[j])
                    self._docs[idx] = meta
                    self._pending_add.add(idx)
                    touched_idx.append(idx)
                    touched_docs.append(meta)
                report["update"].append(item_id)
            else:
                if self._free:
                    idx = self._free.pop()
                    self._write_host_row(idx, norm[j])
                    self._ids[idx] = item_id
                    self._docs[idx] = meta
                    new_active.append(idx)
                    self._pending_add.add(idx)
                    touched_idx.append(idx)
                    touched_docs.append(meta)
                else:
                    if self._capacity is not None:  # unreachable: pre-check
                        raise ValueError("Database capacity exceeded")
                    pending_pos[item_id] = len(new_rows)
                    new_rows.append(j)
                    new_ids.append(item_id)
                    new_docs.append(meta)
                    idx = n_slots + len(new_ids) - 1
                    new_active.append(idx)
                id2idx[item_id] = idx
                report["insert"].append(item_id)
        # bulk append ------------------------------------------------------
        if new_rows:
            stacked = norm[new_rows] if len(new_rows) != n else norm
            if self._host_lazy:
                # appended rows live in the overlay until a full
                # materialization; the device sync scatters them from it
                for t in range(len(new_rows)):
                    self._host_overlay[n_slots + t] = np.array(
                        stacked[t], dtype=Float
                    )
            elif not n_slots:
                self._host_vectors = to_c_f32(stacked)
            else:
                if self._use_memmap and isinstance(
                    self._host_vectors, np.memmap
                ):
                    logger.warning(
                        "Appending to a memmapped file converts it to an "
                        "in-memory numpy array, doubling memory usage. For "
                        "large datasets, consider pre-allocating capacity "
                        "or using a different growth strategy."
                    )
                self._host_vectors = to_c_f32(
                    np.vstack([self._host_vectors, stacked])
                )
            start = n_slots
            self._ids.extend(new_ids)
            self._docs.extend(new_docs)
            self._active_mask = np.concatenate(
                [self._active_mask, np.zeros(len(new_ids), dtype=bool)]
            )
            self._tag_index.resize(len(self._ids))
            touched_idx.extend(range(start, len(self._ids)))
            touched_docs.extend(new_docs)
            self._pending_add.update(range(start, len(self._ids)))
        # active bookkeeping -----------------------------------------------
        if new_active:
            na = np.asarray(new_active, dtype=np.int64)
            self._active_indices = (
                np.append(self._active_indices, na)
                if self._active_indices.size
                else na
            )
            self._active_mask[na] = True
        if touched_idx:
            self._tag_index.update_rows(touched_idx, touched_docs)
        self._ids_np = None
        self._filter_epoch += 1
        self._dirty = True
        return report

    def ingest_device(
        self,
        vectors,
        ids: list[str],
        metadata: Optional[list[Optional[dict]]] = None,
        normalize: bool = True,
        scales=None,
        host_shadow: bool = False,
    ) -> dict[str, list[str]]:
        """Bulk-load a device-resident embedding matrix into a fresh store.

        The device-born counterpart of `upsert_columnar`: `vectors` is a
        jax.Array of shape (n, dim) already living in HBM — typically the
        output of an on-device encoder (models/bert_encoder.py) or an on-device
        data pipeline — and becomes the corpus without ever crossing to the
        host. Normalization, storage-dtype cast, and capacity padding run as
        one jitted device program; host state keeps only ids/metadata.

        The host vector matrix stays *lazy*: `save()`, getters with
        `include_vector=True`, and later row-mutating upserts materialize it
        on demand with a single device->host fetch. Under bfloat16 storage
        the materialized (and therefore persisted) values are the bf16-
        rounded rows — a documented deviation from host-side ingestion,
        where persistence keeps full float32.

        Requires an empty store (no prior rows, no fixed `capacity`, not
        memmapped) and explicit unique ids (content-md5 auto-IDs would need
        the bytes on host — use `upsert_columnar` for that).

        The input array is DONATED: its device buffer is consumed by the
        normalization/cast/pad program (keeping peak HBM to input + padded
        output), so `vectors` must not be used after this call — reading it
        raises jax's deleted-buffer error. Pass a copy if you still need it.

        `host_shadow=True` (lossy storage dtypes) streams the normalized
        f32 rows to host BEFORE the storage-dtype cast and keeps them as
        the authentic host matrix, so the host-f64 rescore tier serves
        exact ranking for device-born int8/int4/bf16 stores — the same
        always-exact contract the reference keeps by ranking full f32
        (picovdb/pico_vdb.py:683-689). Costs one device->host corpus
        transfer at ingest plus host RAM for the f32 matrix; incompatible
        with pre-quantized input (`scales=`), whose f32 form never
        existed. Without it, lossy device-born stores rank at storage
        precision (the host copy is marked lossy and rescore stands down).
        """
        import jax as _jax

        if not isinstance(vectors, _jax.Array):
            raise ValueError(
                "ingest_device expects a device-resident jax.Array; for "
                "host numpy data use upsert_columnar"
            )
        # pre-quantized int4 input arrives PACKED: (n, dim // 2) bytes
        want_dim = (
            self.dim // 2
            if self._dev.storage_dtype == "int4" and scales is not None
            else self.dim
        )
        if vectors.ndim != 2 or vectors.shape[1] != want_dim:
            raise ValueError(
                f"ingest_device expects a 2D array with last dim {want_dim};"
                f" got shape {tuple(vectors.shape)}"
            )
        n = vectors.shape[0]
        if scales is not None:
            # pre-quantized input: rows were normalized-then-quantized by
            # the caller (quantize_rows_i8/_i4), so there is nothing left
            # to normalize — requiring an explicit normalize=False keeps
            # the default from silently doing nothing on mis-scaled rows.
            if self._dev.storage_dtype not in ("int8", "int4"):
                raise ValueError(
                    "scales= is only meaningful for int8/int4 storage; "
                    f"this store is {self._dev.storage_dtype!r}"
                )
            if normalize:
                raise ValueError(
                    "pre-quantized ingest (scales=...) requires "
                    "normalize=False: rows must already be "
                    "normalized-then-quantized (quantize_rows_i8/_i4)"
                )
            if str(vectors.dtype) != "int8":
                raise ValueError(
                    "pre-quantized ingest expects int8 rows (packed bytes "
                    f"for int4 storage); got dtype {vectors.dtype}"
                )
            if getattr(scales, "ndim", 1) != 1 or scales.shape[0] != n:
                raise ValueError(
                    f"scales must be a ({n},) array (one per row); got "
                    f"shape {tuple(getattr(scales, 'shape', ()))}"
                )
        if host_shadow and scales is not None:
            raise ValueError(
                "host_shadow=True needs the f32 rows, which pre-quantized "
                "ingest (scales=...) never materializes; quantize on "
                "device without scales= or keep host_shadow=False"
            )
        if n == 0:
            return {"update": [], "insert": []}
        if ids is None or len(ids) != n:
            raise ValueError(
                f"ingest_device needs exactly one id per row; got "
                f"{0 if ids is None else len(ids)} ids for {n} rows"
            )
        if len(set(ids)) != n:
            raise ValueError("ingest_device ids must be unique")
        if metadata is not None and len(metadata) != n:
            raise ValueError(
                f"metadata length {len(metadata)} != number of vectors {n}"
            )
        with self._rwlock.write_lock():
            if self._ids or self._free or self._use_memmap:
                raise ValueError(
                    "ingest_device requires an empty, non-memmap store; "
                    "use upsert/upsert_columnar on populated stores"
                )
            if self._capacity is not None:
                raise ValueError(
                    "ingest_device does not support fixed-capacity stores"
                )
            # `scales`: pre-quantized int8 device input (built chunk-wise
            # when an f32 intermediate could never fit HBM); rows must be
            # pre-normalized-then-quantized, one f32 scale per row.
            shadow = self._dev.adopt(
                vectors, n, normalize=normalize, scales=scales,
                want_shadow=host_shadow,
            )
            if shadow is not None:
                # authentic pre-cast f32 rows: the host-f64 rescore tier
                # serves exact ranking for this lossy device-born store
                self._host_vectors = shadow
                self._host_lazy = False
                self._host_f32_lossy = False
            else:
                self._host_vectors = None
                self._host_lazy = True
            self._ids = list(ids)
            if metadata is None:
                self._docs = [{K_ID: _id} for _id in ids]
            else:
                self._docs = [
                    {**(m or {}), K_ID: _id} for m, _id in zip(metadata, ids)
                ]
            self._id2idx = None  # lazy: built on first point lookup
            self._active_indices = np.arange(n, dtype=np.int64)
            self._active_mask = np.ones(n, dtype=bool)
            self._tag_index.resize(n)
            self._ids_np = None
            self._pending_add.clear()
            self._pending_remove.clear()
            self._pending_full = False
            self._last_sync_mode = "full"
            # The ANN tier (when enabled) builds lazily on the first query
            # or explicit rebuild_index(), mirroring the reference's lazy
            # FAISS rebuild (picovdb/pico_vdb.py:660-665); the sync step
            # recognizes the device-born mirror as current and skips any
            # host upload. index="auto" follows the sync path's rule
            # (_ann_wanted).
            self._dirty = self._ann_wanted()
            return {"update": [], "insert": list(ids)}

    def _write_host_row(self, idx: int, row: np.ndarray) -> None:
        """Record one mutated host row. Lazy (device-born) stores keep the
        exact f32 row in the overlay — O(changed) memory — instead of
        materializing the whole corpus just to hold it."""
        if self._host_lazy:
            self._host_overlay[idx] = np.array(row, dtype=Float)
        else:
            self._host_vectors[idx] = row

    def _ensure_host_vectors(self) -> None:
        """Materialize the host matrix from the device mirror if lazy.

        One bulk device->host fetch; rows beyond len(_ids) (alignment
        padding) are dropped. Caller must hold the write lock (or be in a
        single-threaded context like load).
        """
        if not self._host_lazy:
            return
        if self._is_multiprocess():
            raise RuntimeError(
                "host materialization of a multi-process store is not "
                "supported: each process holds only its corpus shard. "
                "save() writes per-process shard files; keep mutation "
                "sets under the incremental threshold "
                "(faiss_incremental_threshold_ratio) so syncs stay "
                "O(changed)."
            )
        n = len(self._ids)
        # Fetch the device plane in ROW CHUNKS (each chunk slice allocates
        # only a chunk-sized device buffer before its transfer): a bulk
        # `np.asarray(vectors)` may need a corpus-sized relayout temp on
        # the device, and a device `[:n]` slice would allocate a second
        # corpus-sized buffer outright.
        # Slots at/above the device row count (appends not yet synced) and
        # every overlay slot are filled from `_host_overlay` below.
        if n == 0:
            self._host_vectors = np.empty((0, self.dim), dtype=Float)
        elif self._dev.storage_dtype == "int4":
            # Host-side nibble unpack (layout: quantize_rows_i4 — low
            # nibble = first dim half, high nibble = second half). The
            # device unpack_i4 would materialize the (cap, dim) int8
            # intermediate (2x the packed corpus) next to the resident
            # store; unpacking on host is chunked to bound transients.
            from .ops.quant import unpack_i4_np_into

            avail = min(n, int(self._dev.vectors.shape[0]))
            out = np.zeros((n, self.dim), dtype=Float)
            s = 0
            for packed, scale in self._dev.iter_store_chunks(avail):
                e = s + packed.shape[0]
                unpack_i4_np_into(packed, out[s:e])
                out[s:e] *= scale[:, None]
                s = e
            self._host_vectors = out
        elif self._dev.vstore_scale is not None:  # int8 storage: dequantize
            avail = min(n, int(self._dev.vectors.shape[0]))
            rows = np.zeros((n, self.dim), dtype=Float)
            s = 0
            for raw, scale in self._dev.iter_store_chunks(avail):
                e = s + raw.shape[0]
                rows[s:e] = raw
                rows[s:e] *= scale[:, None]
                s = e
            self._host_vectors = rows
        else:
            avail = min(n, int(self._dev.vectors.shape[0]))
            rows = np.zeros((n, self.dim), dtype=Float)
            step = self._dev.STREAM_CHUNK_ROWS
            for s in range(0, avail, step):
                e = min(s + step, avail)
                rows[s:e] = np.asarray(self._dev.vectors[s:e])
            self._host_vectors = rows
        if self._host_overlay:
            # mutations made while lazy: exact f32 rows (zeros = deleted)
            for idx, row in self._host_overlay.items():
                self._host_vectors[idx] = row
            self._host_overlay.clear()
        if n and self._dev.storage_dtype != "float32":
            # Rows round-tripped through a lossy mirror; the host copy is
            # not authentic f32, so the host rescore tier stands down.
            self._host_f32_lossy = True
        self._host_lazy = False

    def delete(self, ids: list[str]) -> list[str]:
        """Soft-delete vectors by ID; returns the IDs actually deleted."""
        with self._rwlock.write_lock():
            removed: list[str] = []
            removed_idxs: list[int] = []
            zero = np.zeros(self.dim, dtype=Float)
            for _id in ids:
                idx = self._id2idx.pop(_id, None)
                if idx is not None:
                    self._docs[idx] = None
                    if self._host_lazy:
                        self._host_overlay[idx] = zero.copy()
                    else:
                        self._host_vectors[idx].fill(0)
                    self._free.append(idx)
                    removed_idxs.append(idx)
                    removed.append(_id)
            if removed_idxs:
                to_remove = np.asarray(removed_idxs, dtype=np.int64)
                if self._active_indices.size:
                    mask = ~np.isin(self._active_indices, to_remove)
                    self._active_indices = self._active_indices[mask]
                self._active_mask[to_remove] = False
                self._tag_index.clear_rows(removed_idxs)
                for idx in removed_idxs:
                    self._pending_remove.add(idx)
                    self._pending_add.discard(idx)
                self._filter_epoch += 1
                self._dirty = True
            return removed

    def store_additional_data(self, **kwargs) -> None:
        """Store non-searchable auxiliary data persisted in the meta file."""
        with self._rwlock.write_lock():
            self._additional.update(kwargs)

    def get_additional_data(self) -> dict[str, Any]:
        """Auxiliary data previously stored via `store_additional_data`."""
        with self._rwlock.read_lock():
            return self._additional

    def vacuum(self) -> None:
        """Compact the store: drop deleted slots, rebuild maps and the mirror.

        Fixed-capacity stores compact IN PLACE: actives move to the front
        of the pre-allocated buffer (the memmap file is kept) and the tail
        returns to the free list, so inserts keep working until the count
        reaches `capacity` — the reference's observable semantics (its
        vacuum shrinks the array but later appends re-grow it until the
        count check at picovdb/pico_vdb.py:441-442 fires; a 15-seed fuzz
        soak caught this raising "capacity exceeded" right after vacuum).
        """
        with self._rwlock.write_lock():
            if not self._free:
                return
            # compaction REMAPS slots: every cached filter mask (device
            # mask cache and the identity-keyed ids-mask cache) indexes
            # the old positions — bump the epoch so they all miss
            self._filter_epoch += 1
            self._ensure_host_vectors()
            active = np.sort(self._active_indices).tolist()
            n = len(active)
            if self._capacity is not None:
                cap = len(self._ids)
                hv = self._host_vectors
                hv[:n] = np.asarray(hv)[active]  # fancy index copies first
                hv[n:cap] = 0
                self._ids = [self._ids[i] for i in active] + [None] * (
                    cap - n
                )
                self._docs = [self._docs[i] for i in active] + [None] * (
                    cap - n
                )
                self._id2idx = None  # lazy: actives are now _ids[:n]
                self._ids_np = None
                self._active_indices = np.arange(n, dtype=np.int64)
                self._active_mask = np.zeros(cap, dtype=bool)
                self._active_mask[:n] = True
                self._free = list(range(n, cap))
                self._tag_index.reset()
                self._tag_index.resize(cap)
                self._pending_add.clear()
                self._pending_remove.clear()
                if n:
                    self._pending_full = False
                    self._dev.full_upload(
                        self._host_vectors, self._active_mask
                    )
                    self._last_sync_mode = "full"
                    self._rebuild_ann()
                    self._dirty = False
                elif self._dev.vectors is not None:
                    # zero actives: the device mirror may still mark old
                    # rows active (deletes are lazily synced); leave the
                    # store dirty so the next query's sync full-uploads
                    # the cleared mask instead of scattering nothing
                    self._pending_full = True
                    self._ivf = None
                    self._dirty = True
                else:
                    self._pending_full = False
                    self._ivf = None
                    self._dirty = False
                return
            self._host_vectors = to_c_f32(np.asarray(self._host_vectors)[active])
            self._ids = [self._ids[i] for i in active]
            self._docs = [self._docs[i] for i in active]
            self._id2idx = None  # lazy: actives are now dense 0..n-1
            self._ids_np = None
            self._active_indices = np.arange(n, dtype=np.int64)
            self._active_mask = np.ones(n, dtype=bool)
            self._free = []
            self._tag_index.reset()
            self._tag_index.resize(n)
            self._pending_add.clear()
            self._pending_remove.clear()
            if n:
                self._pending_full = False
                self._dev.full_upload(self._host_vectors, self._active_mask)
                self._last_sync_mode = "full"
                self._rebuild_ann()
                self._dirty = False
            elif self._dev.vectors is not None:
                # see the fixed-capacity branch above: repair the device
                # mask at the next sync rather than leaving stale actives
                self._pending_full = True
                self._ivf = None
                self._dirty = True
            else:
                self._pending_full = False
                self._ivf = None
                self._dirty = False

    def rebuild_index(self) -> None:
        """Force a full device mirror refresh (+ ANN rebuild) immediately."""
        with self._rwlock.write_lock():
            if len(self._ids) and not self._host_lazy:
                # (When the host matrix is lazy — device-born ingestion —
                # the mirror already IS the authoritative corpus.)
                self._dev.full_upload(self._host_vectors, self._active_mask)
                self._last_sync_mode = "full"
            elif self._dirty:
                # Lazy store with pending mutations: the overlay rows /
                # deletes have NOT reached the device mirror yet. Apply
                # them through the normal sync before the clears below —
                # clearing unapplied pending sets would silently lose
                # deletes and row updates on device (r5 review finding).
                self._sync_device_locked()
            self._pending_add.clear()
            self._pending_remove.clear()
            self._pending_full = False
            self._rebuild_ann()
            self._dirty = False

    # ------------------------------------------------------------------
    # Query
    # ------------------------------------------------------------------

    @timed("query")
    def query(
        self,
        query_vecs: np.ndarray,
        top_k: int = 10,
        better_than: Optional[float] = None,
        where: WhereArg = None,
        ids: Optional[list[str]] = None,
        ef_search: Optional[int] = None,
        hnsw_ef_search: Optional[int] = None,
    ) -> Union[list[list[dict[str, Any]]], list[dict[str, Any]]]:
        """Cosine top-k query (single vector or batch).

        Heavy math runs on device over an immutable snapshot of the corpus;
        filters compile to a boolean slot mask applied inside the scan
        (reference behavior: picovdb/pico_vdb.py:539-775). `ef_search` /
        `hnsw_ef_search` scale the ANN tier's probe width when active and are
        ignored by the exact tiers.
        """
        raw = np.ascontiguousarray(query_vecs, dtype=Float)
        if raw.ndim == 1:
            if raw.shape[0] != self.dim:
                raise ValueError(
                    f"query vector dim mismatch: expected {self.dim}, "
                    f"got {raw.shape[0]}"
                )
            is_single = True
            vecs2d = raw[None, :]
        elif raw.ndim == 2:
            if raw.shape[1] != self.dim:
                raise ValueError(
                    f"query vectors dim mismatch: expected last dim {self.dim}, "
                    f"got {raw.shape[1]}"
                )
            is_single = False
            vecs2d = raw
        else:
            raise ValueError(
                f"query expects 1D or 2D array with last dim {self.dim}; "
                f"got shape {tuple(raw.shape)}"
            )
        num_q = vecs2d.shape[0]
        # Normalization happens on device, fused into the scan
        # (ops/exact.py:normalize_on_device); the host only validates.
        vecs = to_c_f32(vecs2d)

        # Lazy device synchronization (write lock), mirroring the reference's
        # lazy FAISS rebuild upgrade (picovdb/pico_vdb.py:660-665).
        with self._synced_read():
            # Empty / fully-filtered-out stores return [[]]*num_q even for
            # single-vector queries — matching the reference's early return,
            # which skips its own single-query unwrap
            # (picovdb/pico_vdb.py:595-596, 672-673).
            if not self._active_indices.size:
                return [[] for _ in range(num_q)]
            filtered = ids is not None or where is not None
            filter_mask: Optional[np.ndarray] = None
            if filtered:
                filter_mask = self._build_filter_mask(where, ids)
                n_cand = int(filter_mask.sum())
                if n_cand == 0:
                    return [[] for _ in range(num_q)]
            else:
                n_cand = int(self._active_indices.size)
            # Over-fetch is only needed when assembly can still reject hits:
            # callable `where` is re-applied there (reference semantics,
            # picovdb/pico_vdb.py:769), while dict/ids filters are already
            # exact device-side masks. Selection cost is linear in k, so
            # don't pay the buffer when nothing can be rejected.
            base = top_k + self._adaptive_buffer if callable(where) else top_k
            k_eff = min(base, n_cand)
            self._last_k_eff = int(k_eff)
            rescore = self._host_rescore_applies(num_q)
            if rescore:
                # Inside the read lock: host rows mutate in place under the
                # write lock, so the gather must see a consistent snapshot.
                vals, idxs = self._rescored_dispatch(
                    vecs, k_eff, n_cand, filter_mask, ef_search,
                    hnsw_ef_search, mask_key=self._mask_key(where, ids),
                )
            else:
                vals, idxs = self._dispatch_query(
                    vecs, k_eff, filter_mask, ef_search, hnsw_ef_search,
                    mask_key=self._mask_key(where, ids),
                )
            self._last_rescore = "host" if rescore else None
            if num_q * k_eff <= 4096:
                # Small result sets (the single-query serving path)
                # assemble INSIDE the read lock against the live docs
                # list: snapshotting it costs O(corpus) pointer copies
                # per call (~tens of ms at 25M slots) to read at most
                # Q*k entries, and readers coexist so the brief hold
                # only delays writers (r5 review finding).
                results_batch = self._assemble(
                    vals, idxs, self._docs, top_k, better_than, where
                )
                return results_batch[0] if is_single else results_batch
            docs_ref = list(self._docs)

        # Assembly outside the lock on snapshots (reference:
        # picovdb/pico_vdb.py:752-775). The device arrays are immutable, so
        # the scores/indices are a consistent snapshot by construction.
        results_batch = self._assemble(
            vals, idxs, docs_ref, top_k, better_than, where
        )
        return results_batch[0] if is_single else results_batch

    def _assemble(
        self, vals, idxs, docs_ref, top_k, better_than, where
    ) -> list[list[dict[str, Any]]]:
        """Materialize result dicts from device (scores, slot ids).

        Uses the native C++ loop (picovdb_tpu/native/hostops.cpp, ~1.6x the
        Python loop — dict copies dominate either way) whenever no callable
        `where` needs re-applying.
        """
        where_callable = callable(where)
        if not where_callable:
            from . import hostops

            ext = hostops.get()
            if ext is not None:
                return ext.assemble(
                    np.ascontiguousarray(vals, dtype=np.float32),
                    np.ascontiguousarray(idxs, dtype=np.int32),
                    docs_ref,
                    K_METRICS,
                    int(top_k),
                    float(better_than) if better_than is not None else None,
                )
        results_batch: list[list[dict[str, Any]]] = []
        n_slots = len(docs_ref)
        neg_inf = float("-inf")
        for qi in range(vals.shape[0]):
            results: list[dict[str, Any]] = []
            for idx, score in zip(idxs[qi].tolist(), vals[qi].tolist()):
                if idx < 0 or idx >= n_slots:
                    continue
                if score == neg_inf or score != score:  # -inf or NaN
                    continue
                doc = docs_ref[idx]
                if doc is None:
                    continue
                if better_than is not None and score < better_than:
                    continue
                if where_callable and not where(doc):
                    continue
                results.append({**doc, K_METRICS: score})
                if len(results) == top_k:
                    break
            results_batch.append(results)
        return results_batch

    def query_one(
        self,
        query_vec: np.ndarray,
        top_k: int = 10,
        better_than: Optional[float] = None,
        where: WhereArg = None,
        ids: Optional[list[str]] = None,
        ef_search: Optional[int] = None,
        hnsw_ef_search: Optional[int] = None,
    ) -> list[dict[str, Any]]:
        """Convenience method for single-vector queries."""
        return self.query(  # type: ignore[return-value]
            query_vec,
            top_k=top_k,
            better_than=better_than,
            where=where,
            ids=ids,
            ef_search=ef_search,
            hnsw_ef_search=hnsw_ef_search,
        )

    def query_serial_loop(self, query_vecs: np.ndarray, top_k: int = 10):
        """Measurement lane: M independent Q=1 queries serialized inside
        one device program (see DeviceIndex.query_serial_loop). Returns
        ((M, k) exact scores, (M, k) slot indices) — slot-level results,
        no id mapping; used by bench.py to report device-side single-query
        latency as the slope of wall time vs M."""
        vecs = np.ascontiguousarray(query_vecs, dtype=Float)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"query_serial_loop expects (M, {self.dim}); got "
                f"{tuple(vecs.shape)}"
            )
        with self._synced_read():
            if not self._active_indices.size:
                raise ValueError("query_serial_loop on an empty store")
            return self._dev.query_serial_loop(vecs, top_k)

    def query_batched(
        self,
        query_vecs: np.ndarray,
        top_k: int = 10,
        better_than: Optional[float] = None,
        where: WhereArg = None,
        ids: Optional[list[str]] = None,
        batch_size: int = 1024,
        ef_search: Optional[int] = None,
        hnsw_ef_search: Optional[int] = None,
    ) -> list[list[dict[str, Any]]]:
        """Throughput-mode batch query (new in this framework).

        Splits a large (Q, dim) batch into device-sized chunks, dispatches
        ALL chunks asynchronously, then assembles results chunk by chunk —
        device compute for chunk i+1 overlaps host assembly and transfer
        latency for chunk i. Same result contract as `query` with a 2-D
        input. Use this for offline / high-QPS serving paths.

        `query_vecs` may be a device-resident jax.Array (e.g. embeddings
        produced by an upstream on-device model): no host->device transfer
        happens and normalization stays fused on device.

        Unfiltered chunks route through the ANN tier under the same rule
        as `query` (explicit index="ivf" always probes; "auto" applies
        the probed-union bound per chunk — at the default chunk sizes
        that stays exact); `ef_search`/`hnsw_ef_search` scale the probe
        width exactly as on `query`.
        """
        if isinstance(query_vecs, np.ndarray) or not hasattr(
            query_vecs, "devices"
        ):
            vecs = np.ascontiguousarray(query_vecs, dtype=Float)
        else:
            vecs = query_vecs  # device-resident
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"query_batched expects a 2D array with last dim {self.dim}; "
                f"got shape {tuple(vecs.shape)}"
            )
        num_q = vecs.shape[0]
        if isinstance(vecs, np.ndarray) and self._host_rescore_applies(num_q):
            # Small batches on lossy-storage stores route through the
            # single-dispatch path, which applies the host-f32 exact
            # rescore; chunk overlap doesn't pay at this size anyway.
            return self.query(  # type: ignore[return-value]
                vecs, top_k=top_k, better_than=better_than,
                where=where, ids=ids, ef_search=ef_search,
                hnsw_ef_search=hnsw_ef_search,
            )
        # int8-wire + host exact rescore serving lane (query_wire =
        # "int8_rescore"): queries ship on the 1 B fixed-point wire, the
        # device selects top-(k + wire guard), and the host re-ranks those
        # candidates exactly on the authentic f32 rows — recall 1.0000 at
        # near-int8 wire cost. The reference always ranks exact f32
        # (picovdb/pico_vdb.py:683-689); this lane keeps that contract on
        # a quarter of the upload bytes.
        wire_rescore = (
            isinstance(vecs, np.ndarray) and self._wire_rescore_applies(num_q)
        )
        vecs_f32 = vecs if wire_rescore else None
        # Compact upload wire (engine kwarg `query_wire`): large host
        # batches ship half the bytes; consumers widen on device and
        # normalize fused, so the ranking contract is unchanged.
        vecs = self._wire_encode(vecs, num_q, rescore=wire_rescore)

        with contextlib.ExitStack() as stack:
            stack.enter_context(self._synced_read())
            if wire_rescore and not self._wire_rescore_applies(num_q):
                # eligibility was judged before the lock; a writer may
                # have swapped the corpus in between (e.g. ingest_device
                # dropping the authentic f32 host rows). Fall back to
                # the default wire, re-encoded from the f32 batch we
                # kept for the rescore.
                wire_rescore = False
                vecs = self._wire_encode(vecs_f32, num_q)
                vecs_f32 = None
            if not self._active_indices.size:
                return [[] for _ in range(num_q)]
            filtered = ids is not None or where is not None
            filter_mask = self._build_filter_mask(where, ids) if filtered else None
            n_cand = (
                int(filter_mask.sum()) if filter_mask is not None
                else int(self._active_indices.size)
            )
            if n_cand == 0:
                return [[] for _ in range(num_q)]
            base = top_k + self._adaptive_buffer if callable(where) else top_k
            k_eff = min(base, n_cand)
            self._last_k_eff = int(k_eff)
            # selection width: the wire-rescore guard band rides on top of
            # k_eff so the exact re-rank can recover winners the int8 wire
            # noise displaced by a few ranks
            k_sel = (
                min(k_eff + self._wire_guard, n_cand)
                if wire_rescore else k_eff
            )
            mask_key = self._mask_key(where, ids)
            pending = []
            chunks = []
            chunk_ivf = []    # per chunk: served by the ANN tier
            pack = _pack_fetch_enabled()
            ann_ok = filter_mask is None and self._ann_admits_k(k_sel)
            ef = self._resolve_ef(ef_search, hnsw_ef_search)
            for start in range(0, num_q, batch_size):
                chunk = vecs[start : start + batch_size]
                chunks.append(chunk)
                # Per-chunk ANN routing (the reference's FAISS index serves
                # its batch queries too, pico_vdb.py:716-751): explicit
                # index="ivf" always probes; "auto" probes while the
                # chunk's probed-cluster union bound admits it — at the
                # default 2048-row chunks that routes to exact, so this
                # fires for small batches and forced-IVF stores.
                if ann_ok and self._ann_routes_batch(chunk.shape[0], ef):
                    chunk_ivf.append(True)
                    pending.append(
                        self._ivf_chunk_dispatch(chunk, k_sel, ef, pack)
                    )
                    continue
                chunk_ivf.append(False)
                vd, xd, nq, ke = self._dev.query_async(
                    chunk, k_sel, filter_mask, mask_key=mask_key)
                if pack:
                    pending.append((self._dev.pack_results(vd, xd), nq, ke))
                else:
                    pending.append((vd, xd, nq, ke))
            self._last_topk_strategy = (
                self._ivf_strategy_name()
                if chunk_ivf and chunk_ivf[-1]
                else self._dev.last_strategy
            )
            self._last_rescore = "host-wire" if wire_rescore else None
            # Captured INSIDE the lock: the IVF all-empty-probe self-heal
            # below runs after release, and a concurrent writer may swap
            # the mirror between — re-serving against self._dev would pair
            # new slot indices with the stale docs_ref snapshot (same
            # contract as IVFIndex.search's sync fallback; IVF chunks are
            # unfiltered, so the snapshot's active mask is the full
            # candidate mask).
            snap = self._dev.snapshot() if any(chunk_ivf) else None
            docs_ref = list(self._docs)
            if not wire_rescore:
                # release the read lock for the fetch/assembly phase; the
                # wire-rescore lane instead keeps it held: its host gather
                # must see a consistent row snapshot (rows mutate in place
                # under the write lock — same rule as _rescored_dispatch)
                stack.close()

            _start_host_copies(pending)
            out: list[list[dict[str, Any]]] = []
            row0 = 0
            for chunk, entry, is_ivf in zip(chunks, pending, chunk_ivf):
                if len(entry) == 3:
                    packed, nq, ke = entry
                    vals, idxs = _unpack_fetch(np.asarray(packed), nq, ke)
                else:
                    vals_dev, idxs_dev, nq, ke = entry
                    vals = np.asarray(vals_dev)[:nq, :ke]
                    idxs = np.asarray(idxs_dev)[:nq, :ke]
                if is_ivf and not np.isfinite(vals).any():
                    # every probed cluster was empty (stale centroids /
                    # tiny nprobe): self-heal to the exact scan on the
                    # dispatch-time snapshot rather than return spuriously
                    # empty results
                    vals, idxs = self._dev.query_exact_snapshot(
                        snap, chunk, k_sel
                    )
                    self._exact_retries += 1
                if wire_rescore:
                    vals, idxs = self._host_rescore(
                        vals, idxs, vecs_f32[row0 : row0 + vals.shape[0]]
                    )
                    vals = np.asarray(vals)[:, :k_eff]
                    idxs = np.asarray(idxs)[:, :k_eff]
                row0 += vals.shape[0]
                out.extend(
                    self._assemble(
                        vals, idxs, docs_ref, top_k, better_than, where
                    )
                )
        return out

    def query_columnar(
        self,
        query_vecs,
        top_k: int = 10,
        better_than: Optional[float] = None,
        where: WhereArg = None,
        ids: Optional[list[str]] = None,
        batch_size: int = 2048,
        ef_search: Optional[int] = None,
        hnsw_ef_search: Optional[int] = None,
    ):
        """Serving-mode batch query returning columnar results (new here).

        `batch_size` default 2048: finer chunks pipeline device compute,
        result transfer and host assembly (a policy kept from the first
        platform; to calibrate on the H100).

        Returns `(ids, scores)`: an (Q, top_k) object array of string IDs
        (None marks missing/filtered positions) and an (Q, top_k) float32
        score matrix. Skips per-hit dict materialization — the high-QPS
        serving contract; fetch metadata afterwards with `get(ids)`.
        Accepts host or device-resident query arrays, and routes
        unfiltered chunks through the ANN tier under the same per-chunk
        rule, like `query_batched`.
        """
        if isinstance(query_vecs, np.ndarray) or not hasattr(
            query_vecs, "devices"
        ):
            vecs = np.ascontiguousarray(query_vecs, dtype=Float)
        else:
            vecs = query_vecs
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(
                f"query_columnar expects a 2D array with last dim {self.dim}; "
                f"got shape {tuple(vecs.shape)}"
            )
        num_q = vecs.shape[0]

        empty_ids = np.full((num_q, top_k), None, dtype=object)
        empty_scores = np.full((num_q, top_k), -np.inf, dtype=np.float32)
        with self._synced_read():
            if not self._active_indices.size:
                return empty_ids, empty_scores
            filtered = ids is not None or where is not None
            filter_mask = self._build_filter_mask(where, ids) if filtered else None
            n_cand = (
                int(filter_mask.sum()) if filter_mask is not None
                else int(self._active_indices.size)
            )
            if n_cand == 0:
                return empty_ids, empty_scores
            k_eff = min(top_k, n_cand)
            rescore = (
                self._host_rescore_applies(num_q)
                and isinstance(vecs, np.ndarray)
            )
            mask_key = self._mask_key(where, ids)
            pending = []
            chunks = []
            chunk_ivf = []  # per chunk: served by the ANN tier
            if rescore:
                # Dispatch, exact-rescore and (if the guard band saturates)
                # escalate INSIDE the read lock: the host gather must see a
                # consistent row snapshot, and holding the lock means the
                # mirror cannot swap mid-escalation (small-Q lane only,
                # gated by _rescore_max_q).
                for start in range(0, num_q, batch_size):
                    chunk = vecs[start : start + batch_size]
                    chunks.append(chunk)
                    v, x = self._rescored_dispatch(
                        chunk, k_eff, n_cand, filter_mask, ef_search,
                        hnsw_ef_search, mask_key=mask_key
                    )
                    pending.append((v, x, chunk.shape[0], k_eff))
                    chunk_ivf.append(False)
            else:
                pack = _pack_fetch_enabled()
                ann_ok = filter_mask is None and self._ann_admits_k(k_eff)
                ef = self._resolve_ef(ef_search, hnsw_ef_search)
                # compact upload wire — the host-rescore lane above keeps
                # the caller's f32 batch (its host re-ranking reads it)
                wvecs = self._wire_encode(vecs, num_q)
                for start in range(0, num_q, batch_size):
                    chunk = wvecs[start : start + batch_size]
                    chunks.append(chunk)
                    # per-chunk ANN routing, see query_batched
                    if ann_ok and self._ann_routes_batch(chunk.shape[0], ef):
                        chunk_ivf.append(True)
                        pending.append(
                            self._ivf_chunk_dispatch(chunk, k_eff, ef, pack)
                        )
                        continue
                    chunk_ivf.append(False)
                    vd, xd, nq, ke = self._dev.query_async(
                        chunk, k_eff, filter_mask, mask_key=mask_key)
                    if pack:
                        pending.append(
                            (self._dev.pack_results(vd, xd), nq, ke)
                        )
                    else:
                        pending.append((vd, xd, nq, ke))
            self._last_topk_strategy = (
                self._ivf_strategy_name()
                if chunk_ivf and chunk_ivf[-1]
                else self._dev.last_strategy
            )
            self._last_k_eff = int(k_eff)
            self._last_rescore = "host" if rescore else None
            # see query_batched: the IVF all-empty-probe self-heal must use
            # the dispatch-time snapshot
            snap = self._dev.snapshot() if any(chunk_ivf) else None
            ids_arr = self._ids_array()
            docs_len = len(self._docs)

        _start_host_copies(pending)
        out_ids = np.full((num_q, top_k), None, dtype=object)
        out_scores = np.full((num_q, top_k), -np.inf, dtype=np.float32)
        row = 0
        for chunk, entry, is_ivf in zip(chunks, pending, chunk_ivf):
            if len(entry) == 3:
                packed, nq, ke = entry
                vals, idxs = _unpack_fetch(np.asarray(packed), nq, ke)
            else:
                vals_dev, idxs_dev, nq, ke = entry
                vals = np.asarray(vals_dev)[:nq, :ke]
                idxs = np.asarray(idxs_dev)[:nq, :ke]
            if is_ivf and not np.isfinite(vals).any():
                # all probed clusters empty: self-heal to the exact scan
                # on the dispatch-time snapshot (see query_batched)
                vals, idxs = self._dev.query_exact_snapshot(snap, chunk, k_eff)
                self._exact_retries += 1
            valid = np.isfinite(vals) & (idxs >= 0) & (idxs < docs_len)
            if better_than is not None:
                valid &= vals >= better_than
            safe_idx = np.where(valid, idxs, 0)
            mapped = ids_arr[safe_idx]
            mapped[~valid] = None
            out_ids[row : row + nq, :ke] = mapped
            out_scores[row : row + nq, :ke] = np.where(valid, vals, -np.inf)
            row += nq
        return out_ids, out_scores

    def _ids_array(self) -> np.ndarray:
        """Cached object-dtype mirror of `_ids` for vectorized id mapping."""
        cached = self._ids_np
        if cached is None or len(cached) != len(self._ids):
            self._ids_np = np.asarray(self._ids, dtype=object)
            cached = self._ids_np
        return cached

    # ------------------------------------------------------------------
    # Getters / stats
    # ------------------------------------------------------------------

    def get(
        self, ids: Union[str, list[str]], include_vector: bool = False
    ) -> Union[Optional[dict[str, Any]], list[dict[str, Any]]]:
        """Get records by ID or IDs (missing IDs are skipped in list form)."""
        with self._rwlock.read_lock():
            if isinstance(ids, str):
                idx = self._id2idx.get(ids)
                if idx is None:
                    return None
                return self._record(idx, ids, include_vector)
            out: list[dict[str, Any]] = []
            hit_idxs: list[int] = []
            for _id in ids:
                idx = self._id2idx.get(_id)
                if idx is not None:
                    out.append(self._record(idx, _id, False))
                    hit_idxs.append(idx)
            if include_vector and hit_idxs:
                rows = self._host_rows_batch(hit_idxs)
                for rec, row in zip(out, rows):
                    rec[K_VECTOR] = row
            return out

    def _host_row(self, idx: int) -> np.ndarray:
        """One float32 host row; fetched from the device mirror when the
        host matrix is lazy (device-born ingestion), without materializing
        the whole corpus under a read lock."""
        if self._host_lazy:
            cached = self._host_overlay.get(idx)
            if cached is not None:
                # mutated while lazy: the overlay holds the exact f32 row
                # (fresher than the device mirror until the next sync, and
                # exact where the storage dtype is lossy)
                return np.array(cached, dtype=Float)
            if self._dev.storage_dtype == "int4":
                from .ops.quant import unpack_i4

                row = np.asarray(
                    unpack_i4(self._dev.vectors[idx][None, :])
                )[0].astype(Float)
            else:
                row = np.asarray(self._dev.vectors[idx]).astype(Float)
            if self._dev.vstore_scale is not None:  # quantized storage
                row *= float(self._dev.vstore_scale[idx])
            return row
        return np.array(self._host_vectors[idx], dtype=Float)

    def _host_rows_batch(self, idxs: list[int]) -> np.ndarray:
        """Batched `_host_row`: one chunked device gather instead of a
        device round trip per record (`get_all(include_vector=True)` over
        a multi-million-row device-born store would otherwise be millions
        of per-row fetches). Overlay rows (mutations made
        while lazy) override the gathered mirror rows, exactly as
        `_host_row` serves them."""
        arr = np.asarray(idxs, dtype=np.int64)
        if not self._host_lazy:
            return np.asarray(self._host_vectors)[arr].astype(
                Float, copy=True
            )
        ovl = self._host_overlay
        if ovl and all(int(i) in ovl for i in arr):
            return np.stack([
                np.asarray(ovl[int(i)], dtype=Float) for i in arr
            ])
        # slots at/above the device row count (appends not yet synced)
        # always live in the overlay; clip the gather so jnp.take stays
        # in bounds and let the overlay overwrite those rows below
        dev_rows = self._dev.cap
        rows = self._dev.fetch_rows(np.minimum(arr, dev_rows - 1))
        if ovl:
            for pos, i in enumerate(arr):
                cached = ovl.get(int(i))
                if cached is not None:
                    rows[pos] = cached
        return rows

    def _record(self, idx: int, _id: str, include_vector: bool) -> dict[str, Any]:
        meta = self._docs[idx] or {K_ID: _id}
        rec = dict(meta)
        if include_vector:
            rec[K_VECTOR] = self._host_row(idx)
        return rec

    def get_by_id(
        self, sid: str, include_vector: bool = False
    ) -> Optional[dict[str, Any]]:
        """Deprecated: use `get(sid)` instead."""
        warnings.warn(
            "get_by_id() is deprecated: use get(id) or get([ids])",
            DeprecationWarning,
            stacklevel=2,
        )
        return self.get(sid, include_vector=include_vector)  # type: ignore

    def get_all(
        self, include_vector: bool = False, include_deleted: bool = False
    ) -> list[dict[str, Any]]:
        """All records; deleted slots appear as `{_id_}` placeholders when
        `include_deleted=True` (reference: picovdb/pico_vdb.py:976-1011)."""
        with self._rwlock.read_lock():
            docs: list[dict[str, Any]] = []
            vec_recs: list[dict[str, Any]] = []
            vec_idxs: list[int] = []
            if include_deleted:
                # slot index comes from the enumeration — looking ids up via
                # _id2idx would materialize the lazily-built dict on
                # bulk-ingested stores (engine.__init__: ~50 s at 25M rows)
                for idx, (_id, doc) in enumerate(zip(self._ids, self._docs)):
                    if doc is not None:
                        rec = dict(doc)
                        rec[K_ID] = _id
                        if include_vector:
                            vec_recs.append(rec)
                            vec_idxs.append(idx)
                        docs.append(rec)
                    else:
                        docs.append({K_ID: _id})
            else:
                for idx in self._active_indices.tolist():
                    _id = self._ids[idx]
                    doc = self._docs[idx]
                    if _id is None or doc is None:
                        continue
                    rec = dict(doc)
                    rec[K_ID] = _id
                    if include_vector:
                        vec_recs.append(rec)
                        vec_idxs.append(idx)
                    docs.append(rec)
            if vec_idxs:
                # one chunked device gather for the whole listing instead
                # of a device round trip per record
                rows = self._host_rows_batch(vec_idxs)
                for rec, row in zip(vec_recs, rows):
                    rec[K_VECTOR] = row
            return docs

    def last_query_debug(self) -> dict[str, Any]:
        """Introspection snapshot of the most recent query's execution.

        The device analog of the reference's `_last_topk_strategy`/`_last_k_eff`
        debug fields (picovdb/pico_vdb.py:165-167, 203-204), bundled for
        tooling (SURVEY.md §7.8).
        """
        with self._rwlock.read_lock():
            return {
                "strategy": self._last_topk_strategy,
                "k_eff": self._last_k_eff,
                "sync_mode": self._last_sync_mode,
                "dirty": self._dirty,
                "device_capacity": self._dev.cap,
                "scan_mode": self._dev.scan_mode,
                "storage_dtype": self._dev.storage_dtype,
                "index_kind": self._index_kind,
                "ann_active": self._ivf is not None,
                "ann_rebuild_mode": self._last_ann_rebuild_mode,
                # ANN operating point for operators: what the tier would
                # serve with right now (None when no tier is built)
                "ann_operating_point": (
                    None
                    if self._ivf is None
                    else {
                        "nlist": int(self._ivf.nlist),
                        "nprobe_default": int(
                            self._ivf_nprobe
                            or _ef_to_nprobe(
                                self._ef_search, self._ivf.nlist
                            )
                        ),
                        "layout": (
                            "int8_only"
                            if getattr(self._ivf, "vectors", None) is None
                            else "classic"
                        ),
                        "postings": (
                            "int8"
                            if getattr(self._ivf, "vectors_i8c", None)
                            is not None
                            else str(
                                getattr(
                                    self._ivf.vectors, "dtype", "float32"
                                )
                            )
                        ),
                        # fraction of rows living in the always-probed
                        # overflow regions since the last full build, and
                        # (int8-only layout) the component clip rate of
                        # the last requantize-on-append — the guard that
                        # steers drifted appends back to a full rebuild
                        "overflow_fraction": float(
                            self._ivf.overflow_fraction
                        ),
                        "last_update_clip_fraction": getattr(
                            self._ivf, "last_update_clip_fraction", None
                        ),
                    }
                ),
                # Construction knobs the last build resolved to (None until
                # a build ran): includes the hnsw_m / hnsw_ef_construction
                # translation, so the knobs are observable end to end.
                "ann_build_params": self._ann_build_params,
                "rescore": self._last_rescore,
            }

    def profile_trace(self, log_dir: str):
        """Context manager capturing a device profile around queries.

        Device counterpart of the reference's DEBUG timing logs (SURVEY.md §5
        "Tracing"): wraps `jax.profiler.trace`, so kernel-level timelines of
        whatever runs inside the block land in `log_dir` for TensorBoard /
        xprof. Host-side op timings remain on the "picovdb_tpu" logger at
        DEBUG level.
        """
        import jax

        return jax.profiler.trace(log_dir)

    def stats(self) -> dict[str, Any]:
        """Database statistics, including on-disk file sizes and device info."""
        with self._rwlock.read_lock():
            active = int(self._active_indices.size)
            total = len(self._ids)
            return {
                "active": active,
                "deleted": total - active,
                "total": total,
                "dim": self.dim,
                # Back-compat key: truthy when an ANN acceleration tier exists.
                "faiss": self._index_kind != "exact" and self._ivf is not None,
                "memmap": self._use_memmap,
                "file_sizes": persistence.file_sizes(self._path),
                # device extras
                "device": str(self._dev._device),
                "device_capacity": self._dev.cap,
                "index_kind": self._index_kind,
                "sharded": self._dev.mesh is not None,
                "last_sync_mode": self._last_sync_mode,
                "last_topk_strategy": self._last_topk_strategy,
                "exact_retries": self._exact_retries,
                "storage_dtype": self._dev.storage_dtype,
                # host-f64 rescore tier config (lossy storage): mode,
                # effective guard band, last-query application
                "rescore": {
                    "mode": self._rescore_mode,
                    "guard": self._rescore_guard,
                    "max_q": self._rescore_max_q,
                    "last": self._last_rescore,
                },
                "rescore_escalations": self._rescore_escalations,
                "ann_postings": (
                    None if self._ivf is None else (
                        "int8-only"
                        if getattr(self._ivf, "vectors", None) is None
                        else (
                            "storage+int8"
                            if getattr(self._ivf, "vectors_i8c", None)
                            is not None else "storage"
                        )
                    )
                ),
            }

    # ------------------------------------------------------------------
    # Internals
    # ------------------------------------------------------------------

    @contextlib.contextmanager
    def _synced_read(self):
        """Read lock over a guaranteed-current device mirror.

        Re-checks the dirty flag *inside* the read lock and loops back to the
        sync step when a concurrent writer mutated between releasing the
        write lock and acquiring the read lock — without this, a writer that
        appends rows in that window leaves len(_ids) beyond the mirror's
        capacity and the filtered path would np.pad with a negative width.
        """
        while True:
            with self._rwlock.read_lock():
                if not self._dirty:
                    yield
                    return
            with self._rwlock.write_lock():
                if self._dirty:
                    self._sync_device_locked()

    @staticmethod
    def _freeze_where(where) -> Optional[tuple]:
        """Hashable canonical form of a dict `where`, or None if uncacheable
        (callables, non-hashable values, unknown operator forms)."""
        if not isinstance(where, dict):
            return None
        try:
            parts = []
            for key in sorted(where):
                val = where[key]
                if isinstance(val, dict):
                    if set(val.keys()) != {"$in"}:
                        return None
                    parts.append((key, "$in", tuple(val["$in"])))
                else:
                    parts.append((key, "=", val))
            frozen = tuple(parts)
            # Unhashable values (filters.py's in_mask explicitly supports
            # e.g. {"$in": [[1, 2]]}) must fall back to uncached masks
            # instead of raising at the mask-cache lookup downstream.
            hash(frozen)
            return frozen
        except TypeError:
            return None

    def _wire_encode(self, vecs, num_q: int, rescore: bool = False):
        """Compact upload dtype for a host query batch (constants.py
        rationale: the f32 wire dominates the batch e2e wall on
        bandwidth-limited host links). Device arrays and non-f32 inputs
        pass through; "auto" engages the int16 fixed-point wire from
        QUERY_WIRE_MIN_Q host queries. The host-f64 rescore lanes never
        see wire-encoded queries (their exact re-ranking reads the
        caller's f32 batch)."""
        if not isinstance(vecs, np.ndarray) or vecs.dtype != Float:
            return vecs
        mode = self._query_wire
        if mode == "float32":
            return vecs
        if mode == "auto":
            if num_q < QUERY_WIRE_MIN_Q:
                return vecs
            mode = "int16"
        elif mode == "int8_rescore":
            # adaptive like "auto": tiny batches ship untouched f32. The
            # 1 B plane is only safe with the host re-rank; when the
            # CALLER has no rescore lane (query_columnar — the re-rank
            # exists only in query_batched; r5 review finding) or the
            # rescore can't run (lazy / lossy host rows), fall back to
            # the recall-1.0 int16 wire instead of shipping raw int8.
            if num_q < QUERY_WIRE_MIN_Q:
                return vecs
            mode = (
                "int8"
                if rescore and self._wire_rescore_applies(num_q)
                else "int16"
            )
        from .utils import encode_query_wire

        return encode_query_wire(vecs, mode)

    def _wire_rescore_applies(self, num_q: int) -> bool:
        """Whether the int8-wire + host-exact-rescore serving lane runs:
        opted in (`query_wire='int8_rescore'`), a wire-sized host batch,
        and authentic f32 host rows to re-rank against (same authenticity
        rule as `_host_rescore_applies`)."""
        return (
            self._query_wire == "int8_rescore"
            and num_q >= QUERY_WIRE_MIN_Q
            and not self._host_lazy
            and not self._host_f32_lossy
        )

    _IDS_MASK_CACHE_MAX = 4
    _IDS_MASK_CACHE_MIN_LEN = 64  # tiny lists translate faster than lookup

    def _ids_mask_lookup(self, ids) -> Optional[dict]:
        """Cache entry for this exact ids object at the current epoch, or
        None. Object identity (`is`), not equality: hashing/comparing a
        100k-string list costs as much as rebuilding the mask, while the
        realistic reuse pattern (a caller-held allowlist queried
        repeatedly) keeps one object alive across calls."""
        epoch = self._filter_epoch
        for ent in self._ids_mask_cache:
            if ent["obj"] is ids and ent["epoch"] == epoch:
                return ent
        return None

    def _ids_mask_insert(self, ids, mask: np.ndarray) -> dict:
        mask.flags.writeable = False  # shared across calls: freeze it
        ent = {
            "obj": ids,
            "epoch": self._filter_epoch,
            "mask": mask,
            "token": next(self._ids_mask_token_counter),  # atomic mint
        }
        cache = [
            e for e in self._ids_mask_cache
            if e["obj"] is not ids or e["epoch"] != ent["epoch"]
        ]
        cache.append(ent)
        # oldest-first eviction; list rebuild keeps concurrent readers
        # (holding the previous list object) safe without a lock
        self._ids_mask_cache = cache[-self._IDS_MASK_CACHE_MAX:]
        return ent

    def _mask_key(self, where: WhereArg, ids) -> Optional[tuple]:
        """Device-mask cache key for this filter, or None (don't cache).

        `ids` filters key on the cached translation's token (see
        `_ids_mask_cache`): the id list itself is never hashed."""
        if ids is not None:
            ent = self._ids_mask_lookup(ids)
            if ent is None:
                return None
            if where is None:
                return (self._filter_epoch, "ids", ent["token"])
            frozen = self._freeze_where(where)
            if frozen is None:
                return None
            return (self._filter_epoch, "ids", ent["token"], frozen)
        if where is None:
            return None
        frozen = self._freeze_where(where)
        if frozen is None:
            return None
        return (self._filter_epoch, frozen)

    def _build_filter_mask(
        self, where: WhereArg, ids: Optional[list[str]]
    ) -> np.ndarray:
        """Compile ids/where prefilters to one boolean slot mask."""
        if ids is not None:
            ent = self._ids_mask_lookup(ids)
            if ent is not None:
                mask = ent["mask"]  # read-only; combined below without |=
            else:
                mask = np.zeros(len(self._ids), dtype=bool)
                n = len(ids)
                if n == 1:
                    idx = self._id2idx.get(ids[0])
                    if idx is not None:
                        mask[idx] = True
                elif n:
                    # itemgetter iterates the dict in C; with the vectorized
                    # fancy-index write this is ~3x the per-id Python loop at
                    # 100k ids (the ids-10% profiler scenario was 0.37x the
                    # unfiltered baseline before, round-2 review item 10).
                    # Missing ids are the rare case: fall back per-id.
                    import operator

                    try:
                        got = operator.itemgetter(*ids)(self._id2idx)
                        mask[np.fromiter(got, dtype=np.int64, count=n)] = True
                    except KeyError:
                        hit = [
                            i for i in map(self._id2idx.get, ids)
                            if i is not None
                        ]
                        if hit:
                            mask[np.asarray(hit, dtype=np.int64)] = True
                if n >= self._IDS_MASK_CACHE_MIN_LEN:
                    self._ids_mask_insert(ids, mask)
        else:
            mask = self._active_mask.copy()
        if where is not None:
            wmask = compile_where_mask(
                where, self._docs, self._active_mask, self._tag_index
            )
            mask = mask & wmask  # no |=: `mask` may be the frozen cache entry
        return mask

    def _host_rescore_applies(self, num_q: int) -> bool:
        """Whether this query should re-rank on authentic host f32 rows.

        Only meaningful on lossy-storage stores (bfloat16 floors recall@10
        at ~0.994, int8 at ~0.98 on near-tie corpora): the
        device selects a guard-widened candidate set, the host restores the
        exact f32 ranking. Never applies when the host copy itself came
        from the lossy mirror (device-born stores)."""
        mode = self._rescore_mode
        if mode == "device":
            return False
        if self._dev.storage_dtype == "float32":
            return False
        if self._host_lazy or self._host_f32_lossy:
            return False
        if mode == "host":
            return True
        return num_q <= self._rescore_max_q

    def _rescored_dispatch(self, vecs, k_eff, n_cand, filter_mask,
                           ef_search=None, hnsw_ef_search=None,
                           mask_key=None):
        """Device dispatch + host-f64 rescore + one saturation escalation.

        Caller holds the read lock. Returns (vals, idxs) with k_eff
        columns, exactly ranked against the authentic f32 rows.

        The guard band can saturate: a near-duplicate corpus may pack more
        near-ties than `rescore_guard` candidates (e.g. 250-member clusters
        vs guard 128 — measured recall@10 0.78 at 100k x 256 int8, 1.0000
        after escalation). Detection is principled: every unselected
        point's approx score is <= the selection bottom `a_min`, and its
        exact score is <= a_min + eps (eps = 3x the tier's measured
        quantization-noise rms, ops/quant.selection_noise — random
        corpora's boundary gaps run 5-50x rms, near-duplicate bands sit far
        below it). If a_min + eps reaches the exact k-th score, the true
        top-k may extend past the candidate set: those queries re-dispatch
        once at 4x the width (capped at 4096 — clusters of near-ties wider
        than that exceed the tier's guarantee and are reported via
        `stats()['rescore_escalations']`).
        """
        k_req = min(k_eff + self._rescore_guard, n_cand)
        vals_a, idxs = self._dispatch_query(
            vecs, k_req, filter_mask, ef_search, hnsw_ef_search,
            mask_key=mask_key,
        )
        vals, idxs = self._host_rescore(vals_a, idxs, vecs)
        if k_req < n_cand:
            sat = self._rescore_saturated(vals_a, vals, k_eff)
            k2 = min(max(4 * k_req, 1024), n_cand, 4096)
            if sat.any() and k2 > k_req:
                self._rescore_escalations += int(sat.sum())
                sub = np.ascontiguousarray(np.asarray(vecs)[sat])
                v2a, i2 = self._dispatch_query(
                    sub, k2, filter_mask, ef_search, hnsw_ef_search,
                    mask_key=mask_key,
                )
                v2, i2 = self._host_rescore(v2a, i2, sub)
                vals = np.asarray(vals)[:, :k_eff].copy()
                idxs = np.asarray(idxs)[:, :k_eff].copy()
                vals[sat] = v2[:, :k_eff]
                idxs[sat] = i2[:, :k_eff]
                return vals, idxs
        return np.asarray(vals)[:, :k_eff], np.asarray(idxs)[:, :k_eff]

    def _rescore_saturated(self, vals_approx, vals_exact, k_eff):
        """(Q,) bool: queries whose guard band may be truncated mid-tie
        (see _rescored_dispatch). vals_approx = the device's selection
        scores, vals_exact = the rescored (sorted) exact scores."""
        from .ops.quant import selection_noise

        va = np.asarray(vals_approx, dtype=np.float32)
        finite = np.isfinite(va)
        a_min = np.where(finite, va, np.inf).min(axis=1)
        ve = np.asarray(vals_exact)
        kth = ve[:, min(k_eff, ve.shape[1]) - 1]
        kind = {"bfloat16": "bf16", "int4": "int4"}.get(
            self._dev.storage_dtype, "int8"
        )
        eps = 3.0 * selection_noise(kind, self.dim)
        return finite.any(axis=1) & np.isfinite(kth) & (a_min + eps >= kth)

    def _host_rescore(self, vals, idxs, vecs):
        """Exact re-rank of device candidates (caller holds read lock).

        Gathers the candidate rows from the authoritative host matrix
        (RAM or memmap) and recomputes cosine scores against the
        normalized queries. The gather reads each UNIQUE row once in
        sorted order (page/cache-friendly, unlike a per-candidate
        fancy-index gather) and scoring runs
        in float32 BLAS; queries whose f32 margins are too tight to rank
        reliably (adjacent gaps under ~1e-5 — near-duplicate corpora pack
        true gaps below f32 resolution) are re-scored in float64, so the
        returned ordering matches the old always-f64 pass. Invalid slots
        (-1 padding, -inf/NaN scores) sink to the tail as -inf. Returned
        scores are float32 (the result contract's dtype).
        """
        vals = np.asarray(vals, dtype=np.float32)
        idxs = np.asarray(idxs, dtype=np.int64)
        n_rows = self._host_vectors.shape[0]
        valid = (idxs >= 0) & (idxs < n_rows) & np.isfinite(vals)
        if not valid.any():
            return vals, idxs
        q32 = normalize_batch(np.asarray(vecs, dtype=Float))
        nq, kr = idxs.shape
        flat = np.where(valid, idxs, 0)
        uniq, inv = np.unique(flat.ravel(), return_inverse=True)
        rows_u = np.ascontiguousarray(
            np.asarray(self._host_vectors[uniq], dtype=np.float32)
        )
        inv = inv.reshape(nq, kr)
        ex = np.empty((nq, kr), dtype=np.float32)
        step = max(1, (1 << 22) // max(1, kr * self.dim))  # ~16 MB buffer
        buf = np.empty((step * kr, self.dim), dtype=np.float32)
        for s in range(0, nq, step):
            e = min(nq, s + step)
            m = e - s
            np.take(rows_u, inv[s:e].ravel(), axis=0, out=buf[: m * kr])
            ex[s:e] = np.einsum(
                "qd,qkd->qk", q32[s:e],
                buf[: m * kr].reshape(m, kr, self.dim),
                optimize=True,
            )
        ex = np.where(valid, ex.astype(np.float64), -np.inf)
        order = np.argsort(-ex, axis=1, kind="stable")
        exs = np.take_along_axis(ex, order, axis=1)
        if kr > 1:
            gaps = exs[:, :-1] - exs[:, 1:]
            # nan gaps = two invalid (-inf) tail slots, +inf = valid over
            # invalid: neither is a ranking ambiguity. Neither are
            # zero gaps between DUPLICATE slots (selection tiers may
            # return the same row twice in the guard band; order between
            # copies of one row is meaningless) — without this exclusion
            # ~40% of wire-rescore queries took the f64 path for nothing.
            ids_sorted = np.take_along_axis(idxs, order, axis=1)
            dup = ids_sorted[:, :-1] == ids_sorted[:, 1:]
            ambiguous = (
                (np.nan_to_num(gaps, nan=1.0, posinf=1.0) < 1e-5) & ~dup
            ).any(axis=1)
            if ambiguous.any():
                qa = q32[ambiguous].astype(np.float64)
                rowsa = rows_u[inv[ambiguous].ravel()].astype(np.float64)
                exa = np.einsum(
                    "qd,qkd->qk", qa,
                    rowsa.reshape(qa.shape[0], kr, self.dim),
                )
                ex[ambiguous] = np.where(valid[ambiguous], exa, -np.inf)
                order = np.argsort(-ex, axis=1, kind="stable")
                exs = np.take_along_axis(ex, order, axis=1)
        # Sink guard-band duplicates: the selection tier may return the
        # same row twice (see the zero-gap note above); both copies carry
        # identical exact scores, so without this both could land inside
        # the caller's [:, :k_eff] slice — the same document twice and a
        # true k-th neighbor pushed out. Keep the best-ranked copy, sink
        # the rest to -inf, and re-sort (stable: everything else keeps
        # its order).
        ids_sorted = np.take_along_axis(idxs, order, axis=1)
        bys = np.argsort(ids_sorted, axis=1, kind="stable")
        s_by = np.take_along_axis(ids_sorted, bys, axis=1)
        dup_by = np.zeros(ids_sorted.shape, dtype=bool)
        dup_by[:, 1:] = (s_by[:, 1:] == s_by[:, :-1]) & (s_by[:, 1:] >= 0)
        if dup_by.any():
            dup_sorted = np.zeros_like(dup_by)
            np.put_along_axis(dup_sorted, bys, dup_by, axis=1)
            exs = np.where(dup_sorted, -np.inf, exs)
            reorder = np.argsort(-exs, axis=1, kind="stable")
            exs = np.take_along_axis(exs, reorder, axis=1)
            order = np.take_along_axis(order, reorder, axis=1)
        return (
            exs.astype(np.float32),
            np.take_along_axis(idxs, order, axis=1),
        )

    def _resolve_ef(self, ef_search: Optional[int],
                    hnsw_ef_search: Optional[int]) -> int:
        """Per-call ef chain: hnsw_ef_search -> ef_search -> ctor default
        (reference: picovdb/pico_vdb.py:719-729)."""
        if hnsw_ef_search is not None:
            return int(hnsw_ef_search)
        if ef_search is not None:
            return int(ef_search)
        return self._ef_search

    def _ivf_chunk_dispatch(self, chunk, k_eff: int, ef: int, pack: bool):
        """Async IVF dispatch for one serving-lane chunk.

        Returns the lane's pending entry: packed (buf, nq, k) when the
        single-transfer fetch is on (the probe selects k+guard,
        so results are sliced to k on device — _unpack_fetch's column
        split assumes exactly (Q, 2k)), else the raw (vals, idxs, nq, k)
        tuple. Raw chunks are fine: the IVF tiers normalize fused on
        device, same as the exact path (score parity pinned in
        tests/test_ivf_serving_lanes.py)."""
        vd, xd, nq = self._ivf.search_async(
            chunk, k_eff, ef, self._dev, nprobe=self._ivf_nprobe,
        )
        if pack:
            return (
                self._dev.pack_results(vd[:, :k_eff], xd[:, :k_eff]),
                nq, k_eff,
            )
        return (vd, xd, nq, k_eff)

    def _ivf_strategy_name(self) -> str:
        return (
            "ivf_i8"
            if getattr(self._ivf, "vectors_i8c", None) is not None
            else "ivf"
        )

    def _ann_admits_k(self, k_eff: int) -> bool:
        """Whether the ANN tier can serve this k (unfiltered stores only).

        The probe's selection band must fit inside one IVF tile; very wide
        k goes exact."""
        if (
            self._ivf is None
            or self._index_kind == "exact"
        ):
            return False
        from .ops.ivf import IVF_BN

        return k_eff + 4 <= IVF_BN

    def _ann_routes_batch(self, num_q: int, ef: Optional[int] = None) -> bool:
        """Batch-size routing (auto tier only; explicit index="ivf" always
        probes, like the reference always uses a present FAISS index,
        pico_vdb.py:667-668): the probe scan wins while the batch's
        probed-cluster UNION stays well under the corpus. Draws overlap,
        so the union grows as nlist*(1-(1-nprobe/nlist)^Q), not Q*nprobe;
        route to IVF while the expected union is <= 0.22 of the lists.
        The union metric generalized across nprobe on the first platform
        (clustered 2M x 1024 bf16: IVF won at unions 0.09 and 0.17 and
        lost at 0.30), and 0.22 leans exact, which is always recall 1.0.
        Policy kept; to calibrate on the H100."""
        if self._index_kind != "auto":
            return True
        e = int(ef) if ef is not None else self._ef_search
        npb = self._ivf_nprobe or _ef_to_nprobe(e, self._ivf.nlist)
        p_union = 1.0 - (1.0 - npb / self._ivf.nlist) ** num_q
        return p_union <= 0.22

    def _dispatch_query(self, vecs, k_eff, filter_mask, ef_search,
                        hnsw_ef_search, mask_key=None):
        """Route to the ANN tier (unfiltered) or the exact scan."""
        use_ann = filter_mask is None and self._ann_admits_k(k_eff)
        if use_ann:
            ef = self._resolve_ef(ef_search, hnsw_ef_search)
            num_q = vecs.shape[0] if getattr(vecs, "ndim", 1) == 2 else 1
            use_ann = self._ann_routes_batch(num_q, ef)
        if use_ann:
            vals, idxs = self._ivf.search(
                vecs, k_eff, ef, self._dev, nprobe=self._ivf_nprobe
            )
            self._last_topk_strategy = self._ivf_strategy_name()
            return vals, idxs
        vals, idxs = self._dev.query(vecs, k_eff, filter_mask,
                                     mask_key=mask_key)
        self._last_topk_strategy = self._dev.last_strategy
        return vals, idxs

    @timed("sync_device")
    def _sync_device_locked(self) -> None:
        """Apply pending mutations to the device mirror (caller holds write lock).

        Small change sets scatter in place; large ones re-upload, using the
        `faiss_incremental_threshold_ratio` knob exactly as the reference's
        incremental-vs-full rebuild decision (picovdb/pico_vdb.py:884-921).
        Timed at DEBUG level like the reference's `rebuild_faiss`
        (picovdb/pico_vdb.py:866).
        """
        size = len(self._ids)
        if size == 0:
            self._dirty = False
            return
        mirror_current = (
            self._host_lazy
            and not self._pending_add
            and not self._pending_remove
            and not self._pending_full
            and self._dev.vectors is not None
            and self._dev.cap >= size
        )
        if mirror_current:
            # Device-born corpus (`ingest_device`) with no mutations since:
            # the mirror IS the authoritative data — nothing to upload. The
            # dirty flag only deferred the ANN build (reference laziness:
            # picovdb/pico_vdb.py:660-665).
            changed = []
            ann_rows = None
        else:
            # Lazy (device-born) stores carry their mutations in the
            # overlay — the incremental scatter below reads rows from it,
            # so no materialization happens on the O(changed) path.
            changed = sorted(self._pending_add | self._pending_remove)
        dev_rows = self._dev.cap
        if (
            not mirror_current
            and not self._pending_full
            and changed
            and self._dev.vectors is not None
            and size > dev_rows
        ):
            # append epoch crossed a capacity bucket: grow the device
            # planes in place (d2d pad, no host traffic) so the epoch
            # stays O(changed) — the fallback below re-uploads from host,
            # which on a lazy capacity-tier store materializes the full
            # f32 matrix
            if self._dev.grow(size):
                dev_rows = self._dev.cap
            elif self._ivf is not None:
                # device memory limit with the IVF postings resident
                # (corpus-sized postings can leave no room for the grow
                # transient): free the postings — their warm
                # centroids survive in the stash — retry, and let the ANN
                # block below do a warm full rebuild from the (grown)
                # device corpus. Still no host materialization.
                logger.warning(
                    "device grow to %d rows hit the memory limit; freeing "
                    "the IVF postings and retrying", size,
                )
                self._ivf_warm_blob = getattr(self._ivf, "_host_blob", None)
                self._ivf = None
                import gc

                import jax as _jax

                gc.collect()  # break any cycles pinning the postings
                if self._dev.grow(size):
                    dev_rows = self._dev.cap
                else:
                    logger.warning(
                        "device grow retry failed after freeing the IVF "
                        "postings (%.2f GiB live on device); falling back "
                        "to the host-fed full re-upload",
                        sum(a.nbytes for a in _jax.live_arrays()) / 2**30,
                    )
        need_full = not mirror_current and (
            self._pending_full
            or self._dev.vectors is None
            or size > dev_rows
            or not changed  # unknown change set -> be safe
        )
        if not need_full and not mirror_current and not self._host_lazy:
            # host-backed stores: past the threshold ratio a bulk
            # re-upload beats a huge scatter (reference incremental-vs-
            # full policy, picovdb/pico_vdb.py:884-921). Lazy stores skip
            # this — their re-upload would first materialize the host
            # corpus, so the O(changed) scatter wins at any ratio.
            ratio = len(changed) / float(max(1, min(size, dev_rows)))
            need_full = ratio > max(0.0, self._incr_threshold_ratio)
        ann_rows = None
        if mirror_current:
            pass
        elif need_full:
            # past the incremental threshold (or device growth): the one
            # remaining path that materializes a lazy store's host matrix
            self._ensure_host_vectors()
            self._dev.full_upload(
                np.asarray(self._host_vectors[:size]), self._active_mask
            )
            self._last_sync_mode = "full"
        else:
            idxs = np.asarray(changed, dtype=np.int64)
            if self._host_lazy:
                # adds are in the overlay by construction; removed slots
                # may not be (mask False -> row content is irrelevant)
                zero = np.zeros(self.dim, dtype=Float)
                rows = np.ascontiguousarray(np.stack(
                    [self._host_overlay.get(i, zero) for i in changed]
                ), dtype=Float)
            else:
                rows = np.ascontiguousarray(
                    np.asarray(self._host_vectors)[idxs], dtype=Float
                )
            self._dev.scatter(idxs, rows, self._active_mask[idxs])
            self._last_sync_mode = "incremental"
            ann_rows = (idxs, rows)
        self._pending_add.clear()
        self._pending_remove.clear()
        self._pending_full = False
        if self._ivf is not None or self._ann_wanted():
            # An existing tier is maintained; a missing one is built when
            # index="ivf", or for index="auto" once the store is large
            # enough (_ann_wanted).
            # Incremental ANN maintenance for small change sets: touched
            # rows move to the IVF overflow region in place; a full
            # retrain+reorder only happens past the threshold ratio or
            # when the overflow region fills — the reference's
            # incremental-vs-full FAISS rebuild policy
            # (picovdb/pico_vdb.py:884-921).
            done = False
            if (
                self._ivf is not None
                and ann_rows is not None
                and self._ivf.overflow_fraction
                <= max(0.0, self._incr_threshold_ratio)
            ):
                idxs, rows = ann_rows
                done = self._ivf.update(
                    idxs, rows, self._active_mask[idxs]
                )
                self._ivf = self._ivf  # re-read the postings' size
            if done:
                self._last_ann_rebuild_mode = "incremental"
            else:
                self._rebuild_ann()
                self._last_ann_rebuild_mode = (
                    "full" if self._ivf is not None else None
                )
        self._dirty = False

    def _ivf_i8_only(self) -> bool:
        """Choose the int8-only IVF layout when the classic layout (a
        storage-dtype IVF mirror next to the corpus — ~2x corpus resident)
        would overflow the device memory budget (`_ivf_budget_bytes`).

        Near the limit, corpus + 1 B/element postings still fits where the
        classic layout does not, so int8-only is what makes an ANN tier
        possible there at all; the exact rescore then reads the engine
        corpus by slot id, keeping returned scores at storage-dtype
        precision. PICOVDB_IVF_I8ONLY forces 0/1. Requires the int8
        postings tier to be enabled at this dim.
        """
        import os as _os

        from .ops.ivf import _ivf_i8_enabled

        if self._dev.storage_dtype in ("int8", "int4"):
            # the classic layout's raw reordered mirror cannot be scored
            # (int8: per-row scales; int4: packed nibbles) — int8-only is
            # the only layout. (Below IVF_I8_MIN_DIM the postings' column
            # quantization stacks on the storage quantization;
            # _rebuild_ann skips the build there and serves exact.)
            return True
        env = _os.getenv("PICOVDB_IVF_I8ONLY", "auto").strip().lower()
        # explicit opt-out / opt-in only — 'off'/'no'/typos must not
        # silently force the layout (same rule as PICOVDB_IVF_I8,
        # ops/ivf.py::_ivf_i8_mirror)
        if env in ("0", "false", "off", "no"):
            return False
        if env in ("1", "true", "on", "yes"):
            return _ivf_i8_enabled(self.dim)
        if not _ivf_i8_enabled(self.dim):
            return False
        # Mesh stores hold 1/nshards of both the corpus and the postings
        # per device, so the same budget rule applies per shard.
        shards = 1
        if self._dev.mesh is not None:
            shards = int(self._dev.mesh.shape[self._dev.shard_axis])
        item = _storage_itemsize(self._dev.storage_dtype)
        n = max(int(self._active_indices.size), 1)
        corpus_b = self._dev.cap * self.dim * item // shards
        mirror_b = int(1.05 * n) * self.dim * (item + 1) // shards
        budget = self._ivf_budget_bytes()
        return budget is not None and corpus_b + mirror_b > budget

    @property
    def _ivf(self):
        """The IVF ANN tier (ops/ivf.py, parallel/ivf_mesh.py), or None."""
        return self.__dict__.get("_ivf_tier")

    @_ivf.setter
    def _ivf(self, ivf) -> None:
        # the postings count against the device mirror's temporary budget
        # (DeviceIndex.temp_budget), so every change of tier reaches it
        self.__dict__["_ivf_tier"] = ivf
        dev = self.__dict__.get("_dev")
        if dev is not None:
            dev.ann_bytes = 0 if ivf is None else per_device_bytes(
                vars(ivf).values())

    def _ann_wanted(self) -> bool:
        """Whether the store should carry the IVF tier: always for
        index="ivf"; for index="auto" once the store is large enough
        (ops/ivf.should_build)."""
        if self._index_kind == "ivf":
            return True
        if self._index_kind != "auto":
            return False
        from .ops.ivf import should_build

        n_active = int(self._active_indices.size)
        return bool(n_active) and should_build(
            n_active, self.dim, _storage_itemsize(self._dev.storage_dtype))

    def _ivf_budget_bytes(self) -> Optional[int]:
        """Device memory the corpus and the IVF postings may take together
        (utils.device_memory_limit of the store's device), or None when no
        bound is known."""
        from .utils import device_memory_limit

        dev = self._dev
        device = (dev.mesh.devices.flat[0] if dev.mesh is not None
                  else dev._device)
        return device_memory_limit(device)

    def _ivf_fits(self, n_active: int) -> bool:
        """Whether an IVF postings mirror can sit beside the corpus in
        device memory.

        Postings cost ~1.05 * n rows at 1 B/element (int8-only layout) or
        at the storage width (classic layout, which also carries the int8
        postings mirror at dim >= 256); budget shared with
        `_ivf_i8_only`."""
        import os as _os

        if self._dev.mesh is not None:
            return True  # per-shard residency; the mesh tier self-sizes
        item = _storage_itemsize(self._dev.storage_dtype)
        corpus_b = max(self._dev.cap, n_active) * self.dim * item
        if self._ivf_i8_only():
            post_b = int(1.05 * n_active) * self.dim
        else:
            post_b = int(1.05 * n_active) * self.dim * (item + 1)
        budget = self._ivf_budget_bytes()
        return budget is None or corpus_b + post_b <= budget

    @timed("rebuild_ann")
    def _ivf_build_params(self, n_active: int) -> tuple[Optional[int], int]:
        """Resolve the IVF construction point (nlist, kmeans_iters).

        Explicit `ivf_nlist` wins. Otherwise the reference's HNSW
        construction knobs (picovdb/pico_vdb.py:171-176 drives
        IndexHNSWFlat with them) map onto this tier's construction the
        same way `hnsw_ef_search` maps onto nprobe (SURVEY §7.2):

        - `hnsw_m` (graph degree, default 32) scales the partition count:
          nlist = default_nlist(N) * m/32. Higher m in HNSW buys a denser
          graph (better recall at equal ef); finer partitions buy the
          same trade here — more, smaller clusters probed at the same
          nprobe *fraction*.
        - `hnsw_ef_construction` (build-time beam, default 40) scales
          k-means effort: iters = round(8 * efc/40), clamped to [4, 32].

        Both default-valued knobs leave the build at its tuned defaults,
        so stores built before this mapping serve identically.
        """
        from .ops.ivf import default_nlist

        nlist: Optional[int] = self._ivf_nlist
        if nlist is None and self._hnsw_m != HNSW_M:
            nlist = int(max(8, min(
                4096,
                round(default_nlist(n_active) * self._hnsw_m / HNSW_M),
            )))
        iters = 8
        if self._hnsw_efc != HNSW_EFC:
            iters = int(max(4, min(32, round(8 * self._hnsw_efc / HNSW_EFC))))
        self._ann_build_params = {
            "nlist_requested": nlist,
            "kmeans_iters": iters,
            "hnsw_m": self._hnsw_m,
            "hnsw_ef_construction": self._hnsw_efc,
        }
        return nlist, iters

    def _maybe_warm_mutation_path(self) -> None:
        """Pre-compile the mutation-path executables right after a full
        (re)build on capacity stores, so the first dirty epoch pays
        execution cost only (at capacity shapes the first-use XLA compiles
        of the update scatters take seconds, all inside the first epoch).

        PICOVDB_WARM_UPDATES: "auto" (default) warms stores of >= 1M
        active rows — where each compile costs seconds and epochs are the
        serving-critical path; "1" forces, "0" disables. Identity writes
        on the live buffers; one warm covers every epoch of up to 1024
        changed rows (utils.scatter_bucket). With the persistent XLA
        compile cache the warm itself is compile-bound only on the first
        process ever at these shapes.
        """
        env = os.getenv("PICOVDB_WARM_UPDATES", "auto").strip().lower()
        if env in ("0", "false", "off", "no"):
            return
        if env not in ("1", "true", "on", "yes"):
            from .utils import SCATTER_FLOOR_MIN_ROWS

            # Same constant as the scatter floor (utils.scatter_floor),
            # keyed on the same quantity the floor keys on — the DEVICE
            # PLANE row count (cap / postings rows set the scatter
            # executables' operand shapes), not the active count. Gating
            # on actives opened a window (actives just under 1M, padded
            # plane just over) where every epoch shipped the 1024-row
            # floor operand but the warm never ran. r5 review finding.
            plane_rows = max(
                int(self._active_indices.size),
                int(self._dev.cap or 0),
                # the IVF postings plane carries ~4% slack over actives,
                # so it can cross the floor threshold first
                int(self._ivf.active.shape[0]) if self._ivf is not None
                else 0,
            )
            if plane_rows < SCATTER_FLOOR_MIN_ROWS:
                return
        try:
            t0 = time.perf_counter()
            self._dev.warm_scatter_path()
            if self._ivf is not None:
                self._ivf.warm_update_path()
            logger.info(
                "warmed mutation-path executables in %.2f s",
                time.perf_counter() - t0,
            )
        except Exception:  # pragma: no cover - warm is best-effort
            logger.warning(
                "mutation-path warm failed (non-fatal)", exc_info=True
            )

    def _rebuild_ann(self) -> None:
        """(Re)build the IVF ANN tier when enabled and worthwhile."""
        if self._dev.mesh is not None:
            # Mesh stores use the sharded IVF tier: shared centroids,
            # per-shard cluster-contiguous postings, probe fan-out under
            # shard_map with the cross-device top-k merge (parallel/ivf_mesh.py).
            if self._index_kind == "exact":
                self._ivf = None
                return
            try:
                from .ops.ivf import should_build
                from .parallel.ivf_mesh import ShardedIVF

                n_active = int(self._active_indices.size)
                # int8-only layout: mandatory for int8/int4 storage (raw
                # rows cannot be scored without per-row scales / nibble
                # unpacking) and chosen automatically when the classic
                # per-shard mirror would overflow the per-device budget
                # (same rule as the single-device branch; _ivf_i8_only is
                # mesh-aware). For int4 the slot rescore unpacks the
                # packed corpus rows in place (ops/ivf._rescore_by_slot).
                i8o = self._ivf_i8_only()
                if n_active and self._dev.storage_dtype in ("int8", "int4"):
                    from .ops.ivf import IVF_I8_MIN_DIM, _ivf_i8_enabled

                    if not _ivf_i8_enabled(self.dim):
                        # same gate as the single-device branch below:
                        # quantized storage has no non-int8 postings
                        # layout, and below IVF_I8_MIN_DIM the postings'
                        # column quantization stacks on the storage
                        # quantization
                        if self._index_kind == "ivf":
                            logger.warning(
                                "index='ivf' with %s storage needs dim "
                                ">= %d (or PICOVDB_IVF_I8=1); serving "
                                "exact", self._dev.storage_dtype,
                                IVF_I8_MIN_DIM,
                            )
                        self._ivf = None
                        return
                if n_active and (
                    self._index_kind == "ivf"
                    or (
                        self._index_kind == "auto"
                        and should_build(
                            n_active, self.dim, _storage_itemsize(
                                self._dev.storage_dtype
                            )
                        )
                    )
                ):
                    warm_blob = (
                        self._ivf._host_blob
                        if self._ivf is not None and self._ivf._host_blob
                        else self._ivf_warm_blob
                    )
                    warm = warm_blob["centroids"] if warm_blob else None
                    self._ivf_warm_blob = None
                    self._ivf = None
                    self._ensure_host_vectors()
                    bp_nlist, bp_iters = self._ivf_build_params(n_active)
                    self._ivf = ShardedIVF.build(
                        np.asarray(self._host_vectors[: len(self._ids)]),
                        self._active_mask,
                        self._dev.mesh,
                        shard_axis=self._dev.shard_axis,
                        nlist=bp_nlist,
                        iters=bp_iters,
                        dim=self.dim,
                        warm_centroids=warm,
                        storage_dtype=self._dev.storage_dtype,
                        i8_only=i8o,
                        corpus_cap=self._dev.cap if i8o else None,
                    )
                else:
                    self._ivf = None
            except Exception:  # pragma: no cover - ANN tier is optional
                logger.warning(
                    "sharded ANN tier build failed; staying exact",
                    exc_info=True,
                )
                self._ivf = None
            if self._ivf is not None:
                self._maybe_warm_mutation_path()
            return
        if self._index_kind == "exact":
            self._ivf = None
            return
        try:
            from .ops.ivf import IVFIndex, should_build

            n_active = int(self._active_indices.size)
            if n_active and self._dev.storage_dtype in ("int8", "int4"):
                from .ops.ivf import IVF_I8_MIN_DIM, _ivf_i8_enabled

                if not _ivf_i8_enabled(self.dim):
                    # quantized storage has no non-int8 postings layout,
                    # and below IVF_I8_MIN_DIM the column quantization
                    # stacks on the storage quantization (measured
                    # exact-probe misses at low dim) — serve exact instead
                    if self._index_kind == "ivf":
                        logger.warning(
                            "index='ivf' with %s storage needs dim >= "
                            "%d (or PICOVDB_IVF_I8=1); serving exact",
                            self._dev.storage_dtype, IVF_I8_MIN_DIM,
                        )
                    self._ivf = None
                    return
            if n_active and not self._ivf_fits(n_active):
                # Near the device memory limit even the
                # int8-only postings cannot sit beside the corpus; skip the
                # build instead of OOM-crashing into the except below on
                # every rebuild. Exact serving continues.
                if self._index_kind == "ivf":
                    logger.warning(
                        "IVF postings (%d rows) cannot fit device memory beside the "
                        "corpus; serving exact instead",
                        n_active,
                    )
                self._ivf = None
                return
            if n_active and (
                self._index_kind == "ivf"
                or (
                    self._index_kind == "auto"
                    and should_build(
                        n_active, self.dim, _storage_itemsize(
                            self._dev.storage_dtype
                        )
                    )
                )
            ):
                warm_blob = (
                    self._ivf._host_blob
                    if self._ivf is not None and self._ivf._host_blob
                    else self._ivf_warm_blob
                )
                warm = warm_blob["centroids"] if warm_blob else None
                self._ivf_warm_blob = None
                # Free the old index's device mirror before building the
                # new one — at scale two IVF mirrors can't coexist in HBM
                # (each is ~corpus-sized).
                self._ivf = None
                # Every _rebuild_ann call site syncs the device mirror
                # first, so the build runs fully on device (no corpus
                # host->HBM re-upload) whenever the mirror is current.
                dev_vectors = (
                    self._dev.vectors
                    if (
                        self._dev.mesh is None
                        and self._dev.vectors is not None
                        and self._dev.cap >= len(self._ids)
                    )
                    else None
                )
                if dev_vectors is None:
                    self._ensure_host_vectors()
                bp_nlist, bp_iters = self._ivf_build_params(n_active)
                self._ivf = IVFIndex.build(
                    np.asarray(self._host_vectors[: len(self._ids)])
                    if dev_vectors is None else None,
                    self._active_mask,
                    nlist=bp_nlist,
                    iters=bp_iters,
                    dim=self.dim,
                    warm_centroids=warm,
                    dev_vectors=dev_vectors,
                    storage_dtype=self._dev.storage_dtype,
                    i8_only=self._ivf_i8_only(),
                    dequant_scale=(
                        self._dev.vstore_scale
                        if dev_vectors is not None else None
                    ),
                )
            else:
                self._ivf = None
        except Exception:  # pragma: no cover - ANN tier is optional
            logger.warning("ANN tier build failed; staying exact", exc_info=True)
            self._ivf = None
        if self._ivf is not None:
            self._maybe_warm_mutation_path()

def _ef_to_nprobe(ef: int, nlist: int) -> int:
    from .ops.ivf import ef_to_nprobe

    return ef_to_nprobe(ef, nlist)


def _storage_itemsize(storage_dtype: Optional[str]) -> float:
    """Bytes per corpus element as scanned by the exact sweep."""
    return {"bfloat16": 2.0, "int8": 1.0, "int4": 0.5}.get(
        storage_dtype or "float32", 4.0
    )


def _start_host_copies(pending) -> None:
    """Kick off async device->host copies for all pending result chunks so
    the per-chunk transfer round trips overlap instead of serializing."""
    for entry in pending:
        for arr in entry[:-2]:
            try:
                arr.copy_to_host_async()
            except Exception:
                # host-resident entry (e.g. the rescore lane's numpy
                # results) — skip IT, not the remaining device chunks
                break


def _pack_fetch_enabled() -> bool:
    """See utils.pack_fetch_enabled (single home of the env contract)."""
    from .utils import pack_fetch_enabled

    return pack_fetch_enabled()


def _unpack_fetch(buf: np.ndarray, nq: int, ke: int):
    """Split one fetched (Q, 2k) int32 buffer back into f32 vals + i32 idx."""
    vals = np.ascontiguousarray(buf[:nq, :ke]).view(np.float32)
    idxs = np.ascontiguousarray(buf[:nq, ke: 2 * ke])
    return vals, idxs
