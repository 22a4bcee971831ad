"""Device-resident corpus mirror and query dispatch.

This is the device replacement for both the reference's NumPy score path
(picovdb/pico_vdb.py:670-714) and its FAISS HNSW subsystem
(picovdb/pico_vdb.py:171-212, 716-751, 866-921): the corpus lives in device
memory as a fixed-capacity padded (cap, dim) matrix in the storage dtype
plus a boolean active mask, mutated functionally (donated buffers, scatter
updates) and queried by one XLA program per dispatch (ops/exact.py).

Host state (ids, docs, free slots) remains authoritative — see
`picovdb_tpu.engine`. The device mirror is synchronized lazily before a
query, mirroring the reference's lazy FAISS rebuild
(picovdb/pico_vdb.py:660-665): small mutation sets are scatter-applied,
large ones trigger a full re-upload (the analog of incremental-vs-full
rebuild at picovdb/pico_vdb.py:884-921).
"""

from __future__ import annotations

import functools
import logging
import threading
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .constants import Float, MIN_QUERY_PAD, ROW_PAD
from .utils import (
    DISPATCH_SLOTS,
    device_memory_limit,
    dispatch_slot,
    next_pow2,
    per_device_bytes,
    round_up,
    scatter_bucket,
)
from .ops.exact import (
    make_approx_topk,
    make_exact_topk,
    make_exact_topk_i4r,
    make_exact_topk_i8r,
    scan_block,
)
from .ops.quant import quantize_rows_i4, quantize_rows_i8, unpack_i4_np_into


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(vectors, idx, rows):
    return vectors.at[idx].set(rows)


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_mask(active, idx, vals):
    return active.at[idx].set(vals)


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_1d(arr, idx, vals):
    return arr.at[idx].set(vals)


@functools.partial(jax.jit, static_argnums=(1,))
def _pad_tail_2d(x, pad: int):
    return jnp.pad(x, ((0, pad), (0, 0)))


@functools.partial(jax.jit, static_argnums=(1,))
def _pad_tail_1d(x, pad: int):
    return jnp.pad(x, (0, pad))


@jax.jit
def _pack_vi(vals, idxs):
    """(Q, k) f32 + (Q, k) i32 -> one (Q, 2k) i32 fetch buffer (bitcast)."""
    return jnp.concatenate(
        [jax.lax.bitcast_convert_type(vals, jnp.int32), idxs], axis=1
    )


@jax.jit
def _gather_rows_raw(arr, idx):
    """Storage-dtype row gather: the transfer ships packed/quantized bytes
    and the dequant runs host-side (fetch_rows)."""
    return jnp.take(arr, idx, axis=0)


@jax.jit
def _gather_1d_raw(arr, idx):
    return jnp.take(arr, idx)


@functools.lru_cache(maxsize=64)
def _make_serial_loop(inner):
    """Jitted M-serial-Q=1 runner over a (cached) query kernel. Keyed on
    the kernel closure, which the make_* builders lru_cache themselves."""

    @jax.jit
    def loop(qs, *args):
        def body(c, q):
            vals, idx = inner(q[None, :], *args)
            return c, (vals[0], idx[0])

        return jax.lax.scan(body, 0, qs)[1]

    return loop


def _pad_rows(arr: np.ndarray, cap: int, fill=0) -> np.ndarray:
    if arr.shape[0] == cap:
        return arr
    pad = cap - arr.shape[0]
    widths = ((0, pad),) + ((0, 0),) * (arr.ndim - 1)
    return np.pad(arr, widths, constant_values=fill)


class DeviceIndex:
    """HBM-resident (cap, dim) corpus + active mask with bucketed query dispatch.

    Single-device by default; when constructed with a mesh (see
    `picovdb_tpu.parallel`), arrays are row-sharded and queries run through
    the shard_map path with a cross-device top-k merge.
    """

    def __init__(
        self,
        dim: int,
        device=None,
        mesh=None,
        shard_axis: str = "shard",
        compute_dtype: Optional[str] = None,
        storage_dtype: Optional[str] = None,
        scan_mode: str = "auto",
    ) -> None:
        self.dim = dim
        self.cap = 0
        self.vectors = None  # jax.Array (cap, dim) in storage_dtype
        self.vstore_scale = None  # (cap,) f32 per-row scales (int8 storage)
        self.active = None  # jax.Array (cap,) bool
        self.mesh = mesh
        self.shard_axis = shard_axis
        # bfloat16 storage halves HBM residency and sweep traffic; scoring
        # accumulates in f32 and the winners are exact-rescored against the
        # same storage, so ranking error stays ~1e-3 (guard band absorbs
        # boundary flips). int8 storage quarters residency (per-ROW scales:
        # exact mutation semantics, ~3e-4 score quantization at dim 1024 —
        # tighter than bf16). int4 storage halves int8 again (two nibbles
        # per byte, ops/quant.py) — intended for host-born stores where the
        # engine's host-f64 rescore restores exact ranking. Host
        # persistence remains float32 in every case.
        self.storage_dtype = storage_dtype or "float32"
        if self.storage_dtype not in ("float32", "bfloat16", "int8", "int4"):
            raise ValueError(
                "storage_dtype must be one of float32/bfloat16/int8/int4; "
                f"got {self.storage_dtype!r}"
            )
        if self.storage_dtype == "int4" and dim % 2:
            raise ValueError(
                "int4 storage packs two elements per byte and needs an "
                f"even embedding_dim; got {dim}"
            )
        if compute_dtype is None and self.storage_dtype == "bfloat16":
            compute_dtype = "bfloat16"
        self.compute_dtype = compute_dtype
        self._device = device if device is not None else jax.devices()[0]
        # Single-device scan strategy:
        #   xla    — dot + exact lax.top_k (the default; "auto" = "xla")
        #   approx — dot + lax.approx_max_k + exact rescore of 2k candidates
        if scan_mode not in ("auto", "xla", "approx"):
            raise ValueError(
                "scan_mode must be 'auto', 'xla' or 'approx'; "
                f"got {scan_mode!r}"
            )
        self.scan_mode = scan_mode
        # Per-dispatch strategy introspection. Thread-local: concurrent
        # readers share the RWLock, and each reports the strategy of ITS
        # OWN dispatch — a shared attribute could be overwritten by another
        # thread's dispatch between dispatch and read. Threads that never
        # dispatched read the last global value.
        self._strategy_tls = threading.local()
        self._strategy_global: Optional[str] = None
        # Introspection: how the last device synchronization was applied
        # ("scatter" | "full" | "grow" | None; "grow" = capacity-bucket
        # crossing d2d pad) — analog of the reference's
        # `_last_faiss_rebuild_mode` ("incremental" | "full").
        self.last_sync_mode: Optional[str] = None
        # Device-resident filter-mask cache: serving workloads repeat the
        # same `where` filters, and re-uploading a (cap,) bool mask per
        # query costs a host->device transfer of the corpus *length* each
        # time. Keyed by the
        # engine's frozen filter spec + mutation epoch; cleared on any
        # mirror mutation. Bounded FIFO.
        self._mask_cache: dict = {}
        self.MASK_CACHE_MAX = 32
        # replicated-output row-fetch jits on mesh stores (see _fetch_jit)
        self._fetch_rep_jits: dict = {}
        # Bytes the store's ANN postings hold on each device (set by the
        # engine whenever its IVF tier changes); they count against the
        # temporary budget like the corpus planes (see temp_budget).
        self.ann_bytes = 0
        self._budget_key = None
        self._budget: Optional[int] = None

    @property
    def last_strategy(self) -> Optional[str]:
        """The calling thread's most recent dispatch strategy.

        Thread-local by design (see `_strategy_tls` above): a thread that
        has dispatched at least once always reads ITS OWN latest strategy,
        even if other threads dispatched since; threads that never
        dispatched fall back to the process-wide last value. Cross-thread
        introspection (e.g. a monitoring thread that itself ran a query
        earlier) therefore sees that thread's own — possibly stale — value
        rather than the globally newest one.
        """
        return getattr(self._strategy_tls, "v", self._strategy_global)

    @last_strategy.setter
    def last_strategy(self, value: Optional[str]) -> None:
        self._strategy_tls.v = value
        self._strategy_global = value

    # -- placement -----------------------------------------------------------

    def _row_sharding(self):
        if self.mesh is None:
            return self._device
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P(self.shard_axis, None))

    def _mask_sharding(self):
        if self.mesh is None:
            return self._device
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P(self.shard_axis))

    def _replicated(self):
        if self.mesh is None:
            return self._device
        from jax.sharding import NamedSharding, PartitionSpec as P

        return NamedSharding(self.mesh, P())

    def _padded_cap(self, n: int) -> int:
        cap = round_up(max(n, 1), ROW_PAD)
        if self.mesh is not None:
            nshards = self.mesh.shape[self.shard_axis]
            cap = round_up(cap, ROW_PAD * nshards)
        return cap

    def _cap_with_headroom(self, n: int) -> int:
        """Padded capacity plus append headroom on capacity-tier stores.

        At >=1M rows the ROW_PAD alignment pad is taken anyway (and for
        adopt the pad already costs the transient copy), so widen it to
        ~n/64 extra rows: ~64 append epochs of n/64k rows land in the
        existing plane as O(changed) scatters before `grow()` must pay
        the old+new transient — which at HBM-saturated scale can
        RESOURCE_EXHAUST near the device memory limit.
        When n is already ROW_PAD-aligned (the documented zero-copy
        ceiling recipe, e.g. 12.58M = 1536*8192 int8) the pad stays 0 and
        no headroom is added, preserving the ceiling adopt.
        """
        cap = max(self.cap, self._padded_cap(n))
        if n >= 1_000_000 and cap != n:
            cap = max(cap, self._padded_cap(n + n // 64))
        return cap

    # -- synchronization -------------------------------------------------------

    def _storage_np_dtype(self):
        if self.storage_dtype == "float32":
            return Float
        import ml_dtypes  # ships with jax

        return np.dtype(getattr(ml_dtypes, self.storage_dtype))

    # Batches of up to this many queries dispatch at their own size; larger
    # ones pad to a power of two so the jit cache stays small. Policy kept
    # from the first platform; to calibrate on the H100.
    SMALL_Q_XLA = 16

    # Above this many rows, full uploads stream chunk-by-chunk into a
    # device-resident buffer (donated scatters), so a memmapped corpus
    # larger than host RAM never materializes on the host (SURVEY.md §7.6
    # "memmap streaming host->HBM").
    STREAM_CHUNK_ROWS = 262_144

    def grow(self, n: int) -> bool:
        """Grow padded capacity device-side to hold `n` rows — zero host traffic.

        Append epochs that cross a ROW_PAD capacity bucket used to fall
        back to the host-fed full re-upload (`_ensure_host_vectors` +
        `full_upload`), which on a lazy capacity-tier store materializes
        the full f32 host matrix (~33 GB at 8M x 1024), which can run the
        host out of memory with the IVF postings mirror resident. This
        pads every resident
        plane with zero rows on device instead (d2d, milliseconds) and
        adds a small slack (max(ROW_PAD, n/64)) so subsequent appends stay
        inside the new bucket — keeping mutation epochs O(changed) across
        bucket boundaries (reference bar: incremental must beat full,
        picovdb/pico_vdb.py:884-921).

        Peak HBM is old + new corpus plane. On allocation failure near the
        HBM ceiling the method degrades rather than corrupts: if the core
        plane pad fails the store is untouched; if a later (small) buffer
        fails the device mirror is dropped wholesale. Either way returns
        False and the caller falls back to the full re-upload path.
        """
        if self.vectors is None:
            return False
        slack = max(ROW_PAD, n // 64)
        new_cap = max(self.cap, self._padded_cap(n + slack))
        if new_cap <= self.cap:
            return True
        pad = new_cap - self.cap
        row_sh = self._row_sharding()
        mask_sh = self._mask_sharding()
        committed = False
        try:
            # the big plane first: a failure here leaves the store intact.
            # device_put rebalances the tail padding across shards (the
            # block distribution's row boundaries move with cap).
            vecs = jax.device_put(_pad_tail_2d(self.vectors, pad), row_sh)
            vecs.block_until_ready()
            self.vectors = vecs
            committed = True
            self.active = jax.device_put(
                _pad_tail_1d(self.active, pad), mask_sh
            )
            if self.vstore_scale is not None:
                self.vstore_scale = jax.device_put(
                    _pad_tail_1d(self.vstore_scale, pad), mask_sh
                )
            self.cap = new_cap
        except Exception as e:  # RESOURCE_EXHAUSTED near the HBM ceiling
            if committed:
                # partially grown (corpus plane at new_cap, cap/active
                # still old): drop the mirror wholesale — whether OOM or
                # any other failure — so no later op pairs a new_cap
                # corpus with an old-cap mask; the caller's full
                # re-upload rebuilds every buffer at a consistent cap
                self.vectors = None
                self.vstore_scale = None
            if "RESOURCE_EXHAUSTED" not in str(e):
                raise
            logging.getLogger("picovdb_tpu").warning(
                "device grow %d -> %d rows exhausted HBM (%s)",
                self.cap, new_cap, str(e).split("\n")[0][:160],
            )
            return False
        self._mask_cache.clear()
        self.last_sync_mode = "grow"  # introspection: capacity-bucket
        return True                   # crossing d2d pad (not a sync)

    def full_upload(self, host_vectors: np.ndarray, active_np: np.ndarray) -> None:
        """Upload the whole corpus, growing padded capacity as needed."""
        n = host_vectors.shape[0]
        cap = self._cap_with_headroom(n)
        mask = _pad_rows(np.ascontiguousarray(active_np, dtype=bool), cap)
        if self.storage_dtype in ("int8", "int4") and self.mesh is not None:
            # Sharded quantized corpus: rows + their per-row scales live on
            # the owning shard. Quantization (and for int4 the two-plane
            # nibble pack) is row-local, so one jitted pass over the
            # row-sharded f32 upload partitions with zero collectives
            # (GSPMD keeps in/out row shardings aligned); the f32 staging
            # array is transient, mirroring the existing non-streamed mesh
            # upload below.
            quant = (quantize_rows_i4 if self.storage_dtype == "int4"
                     else quantize_rows_i8)
            vecs = _pad_rows(
                np.ascontiguousarray(np.asarray(host_vectors, dtype=Float)),
                cap,
            )
            f_dev = jax.device_put(vecs, self._row_sharding())
            # no donation: the f32 input cannot alias the narrower
            # quantized outputs, so donating would only warn — but DROP
            # the reference immediately after dispatch so the staging
            # plane frees when the quant completes (donation's other
            # effect), not at the end of the method
            q8, qs = jax.jit(quant)(f_dev)
            del f_dev
            self.vectors = jax.device_put(q8, self._row_sharding())
            self.vstore_scale = jax.device_put(qs, self._mask_sharding())
            self.active = jax.device_put(mask, self._mask_sharding())
            self.cap = cap
            self._mask_cache.clear()
            self.last_sync_mode = "full"
            return
        if self.storage_dtype in ("int8", "int4"):
            # Per-row quantization is chunk-local (each row owns its
            # scale), so the quantized corpus builds in ONE streaming
            # pass: upload an f32 chunk, quantize (+pack, for int4) on
            # device, scatter into the narrow buffer + scale column.
            i4 = self.storage_dtype == "int4"
            quant = quantize_rows_i4 if i4 else quantize_rows_i8
            cols = self.dim // 2 if i4 else self.dim
            buf = jax.device_put(
                jnp.zeros((cap, cols), dtype=jnp.int8), self._device
            )
            scales = jax.device_put(
                jnp.zeros((cap,), dtype=jnp.float32), self._device
            )
            chunk = self.STREAM_CHUNK_ROWS
            for start in range(0, n, chunk):
                rows = np.ascontiguousarray(
                    np.asarray(host_vectors[start:start + chunk], dtype=Float)
                )
                q8, qs = quant(
                    jax.device_put(rows, self._device)
                )
                idx = jax.device_put(
                    np.arange(start, start + rows.shape[0], dtype=np.int32),
                    self._device,
                )
                buf = _scatter_rows(buf, idx, q8)
                scales = _scatter_1d(scales, idx, qs)
            self.vectors = buf
            self.vstore_scale = scales
            self.active = jax.device_put(mask, self._device)
            self.cap = cap
            self._mask_cache.clear()
            self.last_sync_mode = "full"
            return
        sdt = self._storage_np_dtype()
        stream = n > self.STREAM_CHUNK_ROWS and self.mesh is None
        if stream:
            buf = jax.device_put(
                jnp.zeros((cap, self.dim), dtype=jnp.dtype(sdt)), self._device
            )
            chunk = self.STREAM_CHUNK_ROWS
            for start in range(0, n, chunk):
                rows = np.ascontiguousarray(
                    # dtype= copies only on mismatch; .astype would copy
                    # a full chunk even when the store is already f32
                    np.asarray(host_vectors[start : start + chunk],
                               dtype=sdt)
                )
                idx = np.arange(start, start + rows.shape[0], dtype=np.int32)
                buf = _scatter_rows(
                    buf,
                    jax.device_put(idx, self._device),
                    jax.device_put(rows, self._device),
                )
            self.vectors = buf
        else:
            vecs = _pad_rows(
                # dtype= copies only on mismatch (the .astype form copied
                # the whole corpus even when already f32 — ~32 GB of
                # avoidable host transient at 8M x 1024 on mesh stores,
                # which never stream)
                np.ascontiguousarray(np.asarray(host_vectors, dtype=sdt)),
                cap,
            )
            self.vectors = jax.device_put(vecs, self._row_sharding())
        self.active = jax.device_put(mask, self._mask_sharding())
        self.cap = cap
        self._mask_cache.clear()
        self.last_sync_mode = "full"

    def adopt(self, vectors_dev, n: int, normalize: bool = False,
              scales=None, want_shadow: bool = False):
        """Adopt a device-resident (n, dim) array as the full corpus.

        Device-born ingestion: embeddings produced on the device (e.g. by
        the on-device BERT encoder, models/bert_encoder.py) become the corpus
        without ever visiting the host — no host mirror copy, no PCIe
        round trip. One jitted program normalizes (optional), casts to the
        storage dtype, and pads to the aligned capacity; the input buffer
        is donated where it can actually alias (pad == 0, matching dtype)
        and otherwise released as soon as the consuming program is
        dispatched, so peak HBM stays ~input + padded output.

        `want_shadow=True` additionally fetches the normalized f32 rows to
        host BEFORE the storage-dtype cast and returns them (engine
        `host_shadow`: the exact-recall tier for device-born lossy stores).
        Costs one device->host corpus transfer and host RAM for the f32
        matrix; not available for pre-quantized input (`scales`), whose
        f32 form never existed. Returns None otherwise.
        """
        shadow = None
        if want_shadow and scales is None:
            # donate only when the f32 output can alias the input (same
            # dtype); a bf16/int input widens and could never alias
            @functools.partial(
                jax.jit, static_argnums=(1,),
                donate_argnums=(
                    (0,) if vectors_dev.dtype == jnp.float32 else ()
                ),
            )
            def _norm32(x, do_norm):
                x = x.astype(jnp.float32)
                if do_norm:
                    nrm = jnp.linalg.norm(x, axis=1, keepdims=True)
                    e0 = jnp.zeros_like(x).at[:, 0].set(1.0)
                    x = jnp.where(
                        nrm > 0.0, x / jnp.where(nrm > 0, nrm, 1), e0
                    )
                return x

            vectors_dev = _norm32(vectors_dev, bool(normalize))
            shadow = np.asarray(vectors_dev)  # blocks: safe to donate after
            if not shadow.flags.writeable:  # engine mutates host rows
                shadow = shadow.copy()
            normalize = False
        cap = self._cap_with_headroom(n)
        if self.storage_dtype in ("int8", "int4") and scales is not None:
            # pre-quantized device-born input (built chunk-wise when the
            # f32 intermediate could never fit HBM — e.g. 12M x 1024):
            # pad and adopt as-is. For int4 the input is the PACKED
            # (n, dim//2) byte matrix (quantize_rows_i4's layout). NOTE:
            # at the capacity ceiling, build the
            # input with n a ROW_PAD multiple — pad != 0 cannot alias the
            # donated buffer (shape change), so the pad step transiently
            # doubles the corpus (measured OOM at 12.0M x 1024; 12.58M =
            # 1536 * 8192 adopts with zero copies).
            assert vectors_dev.dtype == jnp.int8, vectors_dev.dtype
            if self.storage_dtype == "int4":
                assert vectors_dev.shape[1] == self.dim // 2, (
                    vectors_dev.shape, self.dim
                )

            if cap == n:
                # donation aliases only at pad == 0 (see NOTE above):
                # the zero-copy adopt at ROW_PAD-multiple n
                @functools.partial(jax.jit, donate_argnums=(0, 1))
                def _pad_q0(v8, vs):
                    return v8, vs

                v8, vs = _pad_q0(vectors_dev, scales)
            else:
                # pad changes the shape, so the donated input could never
                # alias — donating here only emits "buffers were not
                # usable" warnings (the transient 2x is inherent)
                @functools.partial(jax.jit, static_argnums=(2,))
                def _pad_q(v8, vs, pad):
                    return (jnp.pad(v8, ((0, pad), (0, 0))),
                            jnp.pad(vs, (0, pad)))

                v8, vs = _pad_q(vectors_dev, scales, cap - n)
            self.vectors = jax.device_put(v8, self._row_sharding())
            self.vstore_scale = jax.device_put(vs, self._mask_sharding())
            self.active = jax.device_put(
                jnp.arange(cap, dtype=jnp.int32) < n, self._mask_sharding()
            )
            self.cap = cap
            self._mask_cache.clear()
            self.last_sync_mode = "full"
            return shadow
        if self.storage_dtype in ("int8", "int4"):
            quant = (quantize_rows_i4 if self.storage_dtype == "int4"
                     else quantize_rows_i8)

            # no donation: the f32 input can never alias the int8/packed
            # output (element width changes), so donating only warns
            @functools.partial(jax.jit, static_argnums=(1, 2))
            def _prep_q(x, pad, do_norm):
                x = x.astype(jnp.float32)
                if do_norm:
                    nrm = jnp.linalg.norm(x, axis=1, keepdims=True)
                    e0 = jnp.zeros_like(x).at[:, 0].set(1.0)
                    x = jnp.where(
                        nrm > 0.0, x / jnp.where(nrm > 0, nrm, 1), e0
                    )
                q8, qs = quant(x)
                if pad:
                    q8 = jnp.pad(q8, ((0, pad), (0, 0)))
                    qs = jnp.pad(qs, (0, pad))
                return q8, qs

            v8, vs = _prep_q(vectors_dev, cap - n, bool(normalize))
            self.vectors = jax.device_put(v8, self._row_sharding())
            self.vstore_scale = jax.device_put(vs, self._mask_sharding())
            self.active = jax.device_put(
                jnp.arange(cap, dtype=jnp.int32) < n, self._mask_sharding()
            )
            self.cap = cap
            self._mask_cache.clear()
            self.last_sync_mode = "full"
            return shadow
        sdt = jnp.dtype(self._storage_np_dtype())
        # donation aliases only when the output keeps the input's shape
        # and dtype (pad == 0, matching storage dtype) — that is the
        # zero-copy adopt documented below; anywhere else it just warns
        alias_ok = (cap == n) and (vectors_dev.dtype == sdt)

        @functools.partial(
            jax.jit, static_argnums=(1, 2),
            donate_argnums=(0,) if alias_ok else (),
        )
        def _prep(x, pad, do_norm):
            if do_norm:
                x = x.astype(jnp.float32)
                nrm = jnp.linalg.norm(x, axis=1, keepdims=True)
                # zero rows map to e0, matching utils.normalize_batch and
                # the reference (picovdb/pico_vdb.py:58-68)
                e0 = jnp.zeros_like(x).at[:, 0].set(1.0)
                x = jnp.where(nrm > 0.0, x / jnp.where(nrm > 0, nrm, 1), e0)
            # normalize=False with matching dtype and no padding is a pure
            # donation pass-through: pre-normalized storage-dtype input
            # (e.g. a 4M x 1024 bf16 matrix built chunk-wise on device)
            # costs zero extra HBM here.
            x = x.astype(sdt)
            if pad:
                x = jnp.pad(x, ((0, pad), (0, 0)))
            return x

        v = _prep(vectors_dev, cap - n, bool(normalize))
        mask = jnp.arange(cap, dtype=jnp.int32) < n
        if self.mesh is None:
            self.vectors = jax.device_put(v, self._device)
            self.active = jax.device_put(mask, self._device)
        else:
            self.vectors = jax.device_put(v, self._row_sharding())
            self.active = jax.device_put(mask, self._mask_sharding())
        self.cap = cap
        self._mask_cache.clear()
        self.last_sync_mode = "full"
        return shadow

    def adopt_global(self, vectors_global, active_np: np.ndarray) -> None:
        """Adopt an externally assembled GLOBAL row-sharded corpus array.

        Multi-process engine load (SURVEY §2 distributed table): each
        process reads only its own checkpoint shard and joins it into one
        global jax.Array (parallel.multihost.load_host_shard); this method
        casts to the storage dtype and pads to the aligned capacity in ONE
        jitted program whose output sharding is the corpus row sharding —
        GSPMD inserts the cross-process row movement, so no
        host ever touches another host's rows. f32/bfloat16 storage only
        (quantized tiers load via their packed plane instead).
        """
        if self.storage_dtype in ("int8", "int4"):
            raise NotImplementedError(
                "adopt_global supports float32/bfloat16 storage; quantized "
                "multi-process stores load via upload_prequantized"
            )
        n = int(vectors_global.shape[0])
        cap = self._cap_with_headroom(n)
        sdt = jnp.dtype(self._storage_np_dtype())

        @functools.partial(
            jax.jit, static_argnums=(1,),
            # donation can alias only when shape and dtype survive the
            # cast+pad; the resharding itself may still block it, but
            # then aliasing is genuinely impossible and the warning is
            # the honest outcome
            donate_argnums=(
                (0,) if (cap == n and vectors_global.dtype == sdt) else ()
            ),
            out_shardings=self._row_sharding(),
        )
        def _pad_cast(v, pad):
            v = v.astype(sdt)
            if pad:
                v = jnp.pad(v, ((0, pad), (0, 0)))
            return v

        self.vectors = _pad_cast(vectors_global, cap - n)
        # active mask: host metadata is replicated across processes, so
        # every process passes the identical padded array and device_put
        # slices out its local rows
        self.active = jax.device_put(
            _pad_rows(np.asarray(active_np, dtype=bool), cap),
            self._mask_sharding(),
        )
        self.cap = cap
        self._mask_cache.clear()
        self.last_sync_mode = "full"

    def scatter(
        self, idxs: np.ndarray, rows: Optional[np.ndarray], active_vals: np.ndarray
    ) -> None:
        """Apply a small mutation set in place (donated buffers, no host copy).

        `rows` may be None for delete-only updates (mask clear); the vector
        rows of deleted slots are then zeroed lazily on the next full upload,
        which is safe because the mask excludes them from scoring.
        """
        if self.vectors is None:
            raise RuntimeError("scatter before any upload")
        n = idxs.shape[0]
        if n == 0:
            return
        # pow2 bucket with a 1024 floor on capacity stores: one executable
        # set per layout covers every small epoch, pre-compiled by
        # warm_scatter_path (utils.scatter_bucket documents the tradeoff)
        pad_n = scatter_bucket(n, self.cap)
        if pad_n != n:
            pad_idx = np.concatenate([idxs, np.repeat(idxs[-1:], pad_n - n)])
            pad_act = np.concatenate(
                [active_vals, np.repeat(active_vals[-1:], pad_n - n)]
            )
        else:
            pad_idx, pad_act = idxs, active_vals
        dev_idx = jax.device_put(pad_idx.astype(np.int32), self._replicated())
        if rows is not None and self.storage_dtype in ("int8", "int4"):
            # per-row scales: mutations quantize exactly, no stale scales
            quant = (quantize_rows_i4 if self.storage_dtype == "int4"
                     else quantize_rows_i8)
            if pad_n != n:
                rows = np.concatenate(
                    [rows, np.repeat(rows[-1:], pad_n - n, axis=0)]
                )
            q8, qs = quant(
                jax.device_put(
                    np.ascontiguousarray(rows, dtype=Float),
                    self._replicated(),
                )
            )
            self.vectors = _scatter_rows(self.vectors, dev_idx, q8)
            self.vstore_scale = _scatter_1d(self.vstore_scale, dev_idx, qs)
        elif rows is not None:
            if pad_n != n:
                rows = np.concatenate([rows, np.repeat(rows[-1:], pad_n - n, axis=0)])
            dev_rows = jax.device_put(
                np.ascontiguousarray(
                    np.asarray(rows).astype(self._storage_np_dtype())
                ),
                self._replicated(),
            )
            self.vectors = _scatter_rows(self.vectors, dev_idx, dev_rows)
        dev_act = jax.device_put(pad_act.astype(bool), self._replicated())
        self.active = _scatter_mask(self.active, dev_idx, dev_act)
        self._mask_cache.clear()
        self.last_sync_mode = "scatter"

    def warm_scatter_path(self, bucket: int = 1024) -> None:
        """Pre-compile `scatter()`'s executables at this layout's shapes
        with IDENTITY writes on the live buffers (write back what is
        already stored), so the first real mutation pays execution cost
        only. `scatter` pads operands to `utils.scatter_bucket` sizes; on
        capacity stores that floors at 1024 rows, so ONE warm at the
        default bucket covers every epoch of up to 1024 changed rows.
        Called by the engine after capacity-tier (re)builds
        (PICOVDB_WARM_UPDATES gates it; see engine._maybe_warm_mutation_path).
        """
        if self.vectors is None:
            return
        rep = self._replicated()
        idx = jax.device_put(np.zeros(bucket, dtype=np.int32), rep)
        if self.storage_dtype in ("int8", "int4"):
            quant = (quantize_rows_i4 if self.storage_dtype == "int4"
                     else quantize_rows_i8)
            # warm the on-device quantizer at the bucket shape; its output
            # is NOT scattered (quantizing zeros is not an identity write)
            q8, _ = quant(jax.device_put(
                np.zeros((bucket, self.dim), dtype=np.float32), rep
            ))
            q8.block_until_ready()
            del q8
            row0 = np.repeat(np.asarray(self.vectors[0:1]), bucket, axis=0)
            self.vectors = _scatter_rows(
                self.vectors, idx,
                jax.device_put(np.ascontiguousarray(row0), rep),
            )
            sc0 = np.repeat(np.asarray(self.vstore_scale[0:1]), bucket)
            self.vstore_scale = _scatter_1d(
                self.vstore_scale, idx, jax.device_put(sc0, rep)
            )
        else:
            row0 = np.repeat(np.asarray(self.vectors[0:1]), bucket, axis=0)
            dev_rows = jax.device_put(np.ascontiguousarray(row0), rep)
            self.vectors = _scatter_rows(self.vectors, idx, dev_rows)
        act0 = np.repeat(np.asarray(self.active[0:1]), bucket).astype(bool)
        self.active = _scatter_mask(
            self.active, idx, jax.device_put(act0, rep)
        )
        jax.block_until_ready(self.active)

    # -- query -----------------------------------------------------------------

    @staticmethod
    def pack_results(vals, idxs):
        """Fuse (vals f32, idxs i32) into one (Q, 2k) int32 device buffer.

        The serving lanes fetch one array per chunk instead of two (one
        device->host transfer with identical bytes). Scores travel bitcast
        in the first k columns; `engine._unpack_fetch` restores them.
        """
        return _pack_vi(vals, idxs)

    # Rows per device gather in fetch_rows: bounds the (chunk, dim) f32
    # transient next to a capacity-tier resident corpus.
    FETCH_CHUNK_ROWS = 262_144

    def fetch_rows(self, idxs: np.ndarray) -> np.ndarray:
        """Batched dequantized float32 host rows by slot id.

        One device gather + one transfer per chunk instead of a per-row
        round trip — restores the reference getter's O(1)-per-row
        host cost (picovdb/pico_vdb.py:945) for device-born stores.
        Indices are padded to power-of-two buckets so repeated calls at
        varying sizes reuse a handful of gather specializations.

        The wire carries STORAGE-dtype bytes (packed int4 rows: 8x fewer
        bytes than f32; int8: 4x; bf16: 2x) and the dequant/unpack runs
        host-side, where it costs one multiply per element.
        """
        if self.vectors is None:
            raise RuntimeError("fetch_rows before any upload")
        idxs = np.asarray(idxs)
        m = idxs.shape[0]
        out = np.empty((m, self.dim), dtype=np.float32)
        step = self.FETCH_CHUNK_ROWS
        for s in range(0, m, step):
            e = min(m, s + step)
            chunk = np.ascontiguousarray(idxs[s:e], dtype=np.int32)
            pad = next_pow2(max(8, chunk.shape[0]))
            if pad != chunk.shape[0]:
                chunk = np.pad(chunk, (0, pad - chunk.shape[0]))
            ci = jax.device_put(chunk, self._replicated())
            raw = np.asarray(
                self._fetch_jit(_gather_rows_raw)(self.vectors, ci)
            )[: e - s]
            if self.vstore_scale is not None:
                scale = np.asarray(
                    self._fetch_jit(_gather_1d_raw)(self.vstore_scale, ci),
                    dtype=np.float32,
                )[: e - s]
            if self.storage_dtype == "int4":
                rows = np.empty((e - s, self.dim), dtype=np.float32)
                unpack_i4_np_into(raw, rows)
                rows *= scale[:, None]
            elif self.vstore_scale is not None:  # int8
                rows = raw.astype(np.float32)
                rows *= scale[:, None]
            else:  # float32 / bfloat16
                rows = np.asarray(raw, dtype=np.float32)
            out[s:e] = rows
        return out

    def _fetch_jit(self, fn):
        """Row-fetch jit, with the output pinned REPLICATED on mesh stores:
        under multi-process every host must be able to read the gathered
        rows locally (a compiler-chosen sharded output would not be fully
        addressable)."""
        if self.mesh is None:
            return fn
        cached = self._fetch_rep_jits.get(fn)
        if cached is None:
            cached = jax.jit(fn, out_shardings=self._replicated())
            self._fetch_rep_jits[fn] = cached
        return cached

    def iter_store_chunks(self, n: int, chunk: Optional[int] = None):
        """Yield the quantized corpus as host (packed_rows, scales) chunks.

        The quantized-persistence writer streams these straight into
        disk-backed memmaps (persistence.save_quantized_atomic), so a
        capacity-tier int8/int4 store checkpoints without ever holding
        more than one chunk of host memory — the f32 matrix the r4 save
        path materialized (engine._ensure_host_vectors) never exists.
        Chunks are fixed-size (last one short): two slice executables
        total, compile-cheap.
        """
        if self.vectors is None or self.vstore_scale is None:
            raise RuntimeError(
                "iter_store_chunks requires a quantized device store"
            )
        step = chunk or self.STREAM_CHUNK_ROWS
        for s in range(0, n, step):
            e = min(n, s + step)
            yield (
                np.asarray(self.vectors[s:e]),
                np.asarray(self.vstore_scale[s:e], dtype=np.float32),
            )

    def upload_prequantized(
        self, plane: np.ndarray, scales: np.ndarray, active_np: np.ndarray
    ) -> None:
        """Build the corpus from a pre-quantized host plane + per-row scales.

        Load-side counterpart of `iter_store_chunks`: `plane` is the
        (n, cols) int8 matrix ((n, dim//2) packed nibbles for int4),
        typically a read-only memmap of `<base>.vecs.q.npy` — chunks are
        scattered into a zero-initialized device buffer, so host RSS stays
        one chunk and the f32 corpus never exists on either side. Works on
        single-device and mesh stores (chunks upload replicated; GSPMD
        routes each row to its owner shard).
        """
        n = plane.shape[0]
        cols = self.dim // 2 if self.storage_dtype == "int4" else self.dim
        if self.storage_dtype not in ("int8", "int4"):
            raise ValueError(
                "upload_prequantized requires int8/int4 storage; "
                f"this store is {self.storage_dtype!r}"
            )
        if plane.ndim != 2 or plane.shape[1] != cols:
            raise ValueError(
                f"quantized plane has shape {plane.shape}; expected "
                f"(*, {cols}) for {self.storage_dtype} at dim {self.dim}"
            )
        if scales.shape[0] != n:
            raise ValueError(
                f"{scales.shape[0]} scales for {n} plane rows"
            )
        cap = self._cap_with_headroom(n)
        rep = self._replicated()
        buf = jax.device_put(
            jnp.zeros((cap, cols), dtype=jnp.int8), self._row_sharding()
        )
        sc = jax.device_put(
            jnp.zeros((cap,), dtype=jnp.float32), self._mask_sharding()
        )
        step = self.STREAM_CHUNK_ROWS
        for s in range(0, n, step):
            e = min(n, s + step)
            idx = jax.device_put(np.arange(s, e, dtype=np.int32), rep)
            buf = _scatter_rows(
                buf, idx,
                jax.device_put(
                    np.ascontiguousarray(plane[s:e], dtype=np.int8), rep
                ),
            )
            sc = _scatter_1d(
                sc, idx,
                jax.device_put(
                    np.ascontiguousarray(scales[s:e], dtype=np.float32), rep
                ),
            )
        self.vectors = buf
        self.vstore_scale = sc
        self.active = jax.device_put(
            _pad_rows(np.asarray(active_np, dtype=bool), cap),
            self._mask_sharding(),
        )
        self.cap = cap
        self._mask_cache.clear()
        self.last_sync_mode = "full"

    def snapshot(self):
        """Immutable handles to the current corpus arrays.

        jax.Arrays are immutable, so holding these gives snapshot isolation
        even if a concurrent writer swaps the mirror afterwards. Callers
        that re-dispatch after releasing the engine lock (the IVF
        empty-probe fallback) MUST query through these captured handles —
        going back to `self.vectors` would pair a new mirror with result
        bookkeeping (docs/ids) captured against the old one.
        """
        return (self.vectors, self.active, self.vstore_scale)

    def _primary_device(self):
        return (self.mesh.devices.flat[0] if self.mesh is not None
                else self._device)

    def temp_budget(self) -> Optional[int]:
        """Bytes one query dispatch's temporaries may take on each device,
        or None when no memory limit is known.

        The device memory limit (utils.device_memory_limit) less this
        store's resident planes on each device — corpus, scales, active
        mask, the filter-mask cache at its cap, the ANN postings — shared
        among utils.DISPATCH_SLOTS concurrent dispatches. What other work
        holds at dispatch time does not enter, so a query shape always
        takes the same route (and the same compiled program) for a given
        set of planes. Recomputed when the capacity, the postings or the
        limit override change."""
        import os

        from .utils import ENV_DEVICE_MEMORY_MB

        key = (self.cap, self.ann_bytes, os.getenv(ENV_DEVICE_MEMORY_MB))
        if key != self._budget_key:
            limit = device_memory_limit(self._primary_device())
            budget = None
            if limit is not None:
                planes = per_device_bytes(
                    (self.vectors, self.vstore_scale, self.active))
                masks = self.MASK_CACHE_MAX * per_device_bytes(
                    (self.active,))
                budget = max(0, limit - planes - masks - self.ann_bytes)
                budget //= DISPATCH_SLOTS
            self._budget_key, self._budget = key, budget
        return self._budget

    def dispatch_slot(self):
        """One of the device's utils.DISPATCH_SLOTS, held around a query
        dispatch so concurrent readers' temporaries stay inside the
        budget they were sized against (see temp_budget)."""
        return dispatch_slot(self._primary_device())

    def _scan_fn(self, k: int, num_q: int, rows: int, vscale):
        """(jitted fn, strategy) of the exact route for this store.

        The fn takes (queries, vectors, mask) and closes over `vscale`.
        The row block is sized from the store's temporary budget
        (ops/exact.scan_block over temp_budget): dense when the (Q, rows)
        temporaries fit, otherwise a blocked walk, named with a
        "_blocked" suffix."""
        i4 = self.storage_dtype == "int4"
        route = "i4r" if i4 else ("i8r" if vscale is not None else "f32")
        block = scan_block(rows, num_q, route, self.dim, self.temp_budget())
        if route == "i4r":
            f = make_exact_topk_i4r(k, block=block)
            name = "i4stor_xla"
        elif route == "i8r":
            f = make_exact_topk_i8r(k, block=block)
            name = "i8stor_xla"
        else:
            f = make_exact_topk(k, self.compute_dtype, block=block)
            name = "xla_topk"
        if vscale is not None:
            g = f
            f = lambda q, v, m: g(q, v, vscale, m)  # noqa: E731
        return f, name + ("_blocked" if block else "")

    def query_exact_snapshot(self, snap, qnorm, k):
        """Exact masked top-k against a captured `snapshot()`.

        Blocking; returns host (vals, idxs) of (Q, min(k, cap)). Used by
        the engine's IVF empty-probe fallback so the re-dispatch sees
        exactly the arrays the original dispatch saw.
        """
        vectors, active, vscale = snap
        num_q = qnorm.shape[0]
        if isinstance(qnorm, np.ndarray):
            q_dev = jax.device_put(
                np.ascontiguousarray(qnorm, dtype=Float), self._replicated()
            )
        else:
            q_dev = qnorm.astype(jnp.float32)
        k_eff = min(k, vectors.shape[0])
        # plain jit on mesh stores too: GSPMD partitions the row-sharded
        # snapshot for any batch size
        fn, _ = self._scan_fn(k_eff, num_q, vectors.shape[0], vscale)
        with self.dispatch_slot():
            vals, idxs = fn(q_dev, vectors, active)
        return np.asarray(vals)[:num_q], np.asarray(idxs)[:num_q]

    def _sharded_fn(self, k: int, num_q: int, vscale):
        """Sharded route; each shard's temporaries are bounded like the
        single-device routes, over its own rows."""
        from .parallel.sharded_query import make_sharded_topk

        route = {"int8": "i8r", "int4": "i4r"}.get(self.storage_dtype, "f32")
        block = scan_block(
            self.cap // self.mesh.shape[self.shard_axis], num_q, route,
            self.dim, self.temp_budget(),
        )
        if vscale is None:
            return make_sharded_topk(self.mesh, self.shard_axis, k,
                                     self.compute_dtype, block=block)
        fn = make_sharded_topk(
            self.mesh, self.shard_axis, k, None,
            storage_i8=self.storage_dtype == "int8",
            storage_i4=self.storage_dtype == "int4", block=block,
        )
        return lambda q, v, m: fn(q, v, vscale, m)  # noqa: E731

    def query(
        self,
        qnorm: np.ndarray,
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        mask_key=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Masked top-k over the device corpus (blocking).

        Args:
          qnorm: (Q, dim) float32 normalized queries (host).
          k: requested candidates per query (clamped to capacity).
          filter_mask: optional (size,) bool host mask (already ANDed with
            active by the caller); None means "all active rows".

        Returns (values, indices) as host NumPy, shapes (Q, k); padding
        entries (fewer than k candidates) carry -inf values.
        """
        vals, idxs, num_q, k_eff = self.query_async(
            qnorm, k, filter_mask, mask_key=mask_key
        )
        from .utils import pack_fetch_enabled

        if pack_fetch_enabled():
            # one host fetch instead of two
            buf = np.asarray(_pack_vi(vals, idxs))
            vals = np.ascontiguousarray(
                buf[:num_q, :k_eff]).view(np.float32)
            idxs = np.ascontiguousarray(buf[:num_q, k_eff: 2 * k_eff])
            return vals, idxs
        vals = np.asarray(vals)[:num_q, :k_eff]
        idxs = np.asarray(idxs)[:num_q, :k_eff]
        return vals, idxs

    def query_async(
        self,
        qnorm: np.ndarray,
        k: int,
        filter_mask: Optional[np.ndarray] = None,
        mask_key=None,
    ):
        """Dispatch a masked top-k; returns device arrays without blocking.

        Returns (vals_dev, idxs_dev, num_q, k_eff): callers slice
        `np.asarray(...)[:num_q, :k_eff]` when they need the results, letting
        throughput paths pipeline several dispatches ahead of host fetches
        (hides host<->device round-trip latency).

        `qnorm` may be raw (normalization happens on device, fused into the
        scan) and may already be a device-resident jax.Array — the serving
        path for query embeddings produced by an upstream on-device model —
        in which case no host->device transfer happens at all.

        Routes (`last_strategy`): "sharded_scan[_i8stor|_i4stor]" on mesh
        stores; otherwise the storage dtype's exact XLA route
        ("i8stor_xla", "i4stor_xla", "xla_topk" for f32/bf16), or
        "xla_approx" under scan_mode="approx" for float stores. A
        "_blocked" suffix marks a dispatch that walked the corpus in row
        blocks to stay inside the store's temporary budget (temp_budget).
        """
        if self.vectors is None or self.cap == 0:
            raise RuntimeError("query before any upload")
        num_q = qnorm.shape[0]
        q_pad = (num_q if num_q <= self.SMALL_Q_XLA
                 else max(MIN_QUERY_PAD, next_pow2(num_q)))
        if isinstance(qnorm, np.ndarray):
            if qnorm.dtype != Float and qnorm.dtype.itemsize > 2:
                qnorm = np.ascontiguousarray(qnorm, dtype=Float)
            if q_pad != num_q:
                padq = np.zeros((q_pad, self.dim), dtype=qnorm.dtype)
                padq[:num_q] = qnorm
                qnorm = padq
            q_dev = jax.device_put(
                np.ascontiguousarray(qnorm), self._replicated()
            )
            if q_dev.dtype != jnp.float32:
                # compact query wire (engine._wire_encode): half the
                # upload bytes, one cached widening op on device —
                # ranking is unchanged because queries L2-normalize on
                # device after the cast
                q_dev = q_dev.astype(jnp.float32)
        else:
            q_dev = qnorm
            if q_dev.dtype != jnp.float32:
                q_dev = q_dev.astype(jnp.float32)
            if q_pad != num_q:
                q_dev = jnp.pad(q_dev, ((0, q_pad - num_q), (0, 0)))
            if self.mesh is not None:
                q_dev = jax.device_put(q_dev, self._replicated())

        if filter_mask is None:
            mask_dev = self.active
        elif mask_key is not None and mask_key in self._mask_cache:
            mask_dev = self._mask_cache[mask_key]
        else:
            m = _pad_rows(np.ascontiguousarray(filter_mask, dtype=bool), self.cap)
            mask_dev = jax.device_put(m, self._mask_sharding())
            if mask_key is not None:
                if len(self._mask_cache) >= self.MASK_CACHE_MAX:
                    # concurrent readers may evict the same entry; dict ops
                    # are GIL-atomic but the oldest key may already be gone
                    try:
                        self._mask_cache.pop(
                            next(iter(self._mask_cache)), None
                        )
                    except (StopIteration, RuntimeError):
                        pass
                self._mask_cache[mask_key] = mask_dev

        # Dispatch with the exact k (not a pow2 bucket): top_k's cost grows
        # with k, and each distinct k is one small compile.
        k_eff = min(k, self.cap)
        quantized = self.storage_dtype in ("int8", "int4")
        if self.mesh is not None:
            fn = self._sharded_fn(k_eff, q_pad, self.vstore_scale)
            self.last_strategy = (
                f"sharded_scan_i{self.storage_dtype[3]}stor" if quantized
                else "sharded_scan"
            )
        elif self.scan_mode == "approx" and not quantized:
            fn = make_approx_topk(k_eff, self.compute_dtype)
            self.last_strategy = "xla_approx"
        else:
            fn, self.last_strategy = self._scan_fn(
                k_eff, q_pad, self.cap, self.vstore_scale
            )
        with self.dispatch_slot():
            vals, idxs = fn(q_dev, self.vectors, mask_dev)
        return vals, idxs, num_q, k_eff

    def query_serial_loop(self, queries, k: int):
        """Run M independent Q=1 queries serially inside ONE device program.

        `lax.scan` serializes the iterations on the device, each sweeping
        the full corpus through the same route a Q=1 dispatch takes. One
        launch amortizes per-dispatch host/driver overhead across all M
        queries, so the marginal cost per additional query — the slope of
        wall time vs M — is the device-side single-query latency, free of
        host and transport noise (bench.py reports it as
        `single_query_device_ms`).

        `queries` is an (M, dim) float32 array (host or device); rows are
        normalized on device like every query path. Returns host
        ((M, k) f32 scores, (M, k) int32 slot ids). Single-device stores
        only.
        """
        if self.mesh is not None:
            raise ValueError("query_serial_loop is single-device only")
        if self.vectors is None:
            raise ValueError(
                "empty device mirror; sync first (or use "
                "PicoVectorDB.query_serial_loop, which does)"
            )
        k_eff = min(k, self.cap)
        block = scan_block(
            self.cap, 1, {"int8": "i8r", "int4": "i4r"}.get(
                self.storage_dtype, "f32"),
            self.dim, self.temp_budget(),
        )
        if self.storage_dtype == "int4":
            inner = make_exact_topk_i4r(k_eff, block=block)
            args = (self.vectors, self.vstore_scale, self.active)
            name = "i4stor_xla"
        elif self.storage_dtype == "int8":
            inner = make_exact_topk_i8r(k_eff, block=block)
            args = (self.vectors, self.vstore_scale, self.active)
            name = "i8stor_xla"
        else:
            inner = make_exact_topk(k_eff, self.compute_dtype, block=block)
            args = (self.vectors, self.active)
            name = "xla_topk"
        self.last_strategy = name + ("_blocked" if block else "") + "_loop"
        loop = _make_serial_loop(inner)

        if isinstance(queries, np.ndarray):
            queries = jax.device_put(
                np.ascontiguousarray(queries, dtype=Float), self._device
            )
        with self.dispatch_slot():
            vals, idxs = loop(queries, *args)
        return np.asarray(vals), np.asarray(idxs)
