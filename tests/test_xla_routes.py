"""The XLA query routes against a float64 oracle, and what bounds them.

Every storage dtype's route (float32, bfloat16, int8, int4) is checked end to
end through the public API, with and without a filter, at Q in {1, 300} and
k in {1, 10}; the device routes themselves against the oracle over the
corpus as stored; the row-blocked scan against the dense one; the
precision of every float32 scoring dot; the memory budget that chooses the
block; the compile-cache placement; and the removed kernel options.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID, K_METRICS
from picovdb_tpu.device import DeviceIndex
from picovdb_tpu.ops import exact as ex
from picovdb_tpu.ops.quant import quantize_rows_i4, quantize_rows_i8, unpack_i4
from picovdb_tpu.utils import normalize_batch

DIM = 64
N = 2000
STORAGES = ("float32", "bfloat16", "int8", "int4")


def _corpus(rng, n=N, dim=DIM, centers=40, noise=0.35):
    c = normalize_batch(rng.normal(size=(centers, dim)).astype(np.float32))
    x = c[rng.integers(0, centers, n)] + (noise / np.sqrt(dim)) * rng.normal(
        size=(n, dim)).astype(np.float32)
    return normalize_batch(x.astype(np.float32))


def _oracle(q, v, k, mask=None):
    """f64 top-(k+1): ids and scores, rows outside `mask` excluded."""
    q64 = q.astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    s = q64 @ v.astype(np.float64).T
    if mask is not None:
        s[:, ~mask] = -np.inf
    order = np.argsort(-s, axis=1, kind="stable")[:, : k + 1]
    return order, np.take_along_axis(s, order, axis=1)


def _assert_matches(ids, scores, oracle, k, tol=1e-5):
    o_ids, o_sc = oracle
    for i in range(len(ids)):
        n_valid = int(np.isfinite(o_sc[i, :k]).sum())
        assert len(ids[i]) == n_valid
        tie = (o_sc.shape[1] > k and np.isfinite(o_sc[i, k])
               and o_sc[i, k - 1] - o_sc[i, k] < tol)
        if not tie:
            assert set(ids[i]) == set(o_ids[i, :n_valid].tolist())
        np.testing.assert_allclose(scores[i], o_sc[i, :n_valid], atol=tol)


@pytest.fixture(scope="module")
def corpus():
    return _corpus(np.random.default_rng(11))


@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("num_q", [1, 300])
@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("storage", STORAGES)
def test_route_matches_f64_oracle(tmp_path, corpus, storage, filtered,
                                  num_q, k):
    """Public API, every storage route: exact ids and 1e-5 scores against
    the float64 oracle (lossy storage through the host rescore)."""
    rng = np.random.default_rng(num_q * 7 + k)
    db = PicoVectorDB(
        embedding_dim=DIM, storage_file=str(tmp_path / "db"),
        storage_dtype=storage, index="exact",
        rescore="host" if storage != "float32" else None,
    )
    db.upsert_columnar(corpus.copy(), ids=[str(i) for i in range(N)],
                       metadata=[{"g": i % 4} for i in range(N)])
    q = corpus[rng.integers(0, N, num_q)] + 0.05 * rng.normal(
        size=(num_q, DIM)).astype(np.float32)
    mask = (np.arange(N) % 4) == 1 if filtered else None
    hits = db.query(q, top_k=k, where={"g": 1} if filtered else None)
    strategy = db.last_query_debug()["strategy"]
    assert strategy == {"float32": "xla_topk", "bfloat16": "xla_topk",
                        "int8": "i8stor_xla", "int4": "i4stor_xla"}[storage]
    ids = [[int(h[K_ID]) for h in row] for row in hits]
    scores = [[h[K_METRICS] for h in row] for row in hits]
    _assert_matches(ids, scores, _oracle(q, corpus, k, mask), k)


def _stored(storage, v):
    """The corpus as the device route scores it (dequantized / rounded)."""
    if storage == "bfloat16":
        return np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    if storage == "int8":
        q8, s = quantize_rows_i8(jnp.asarray(v))
        return np.asarray(q8, np.float32) * np.asarray(s)[:, None]
    if storage == "int4":
        q4, s = quantize_rows_i4(jnp.asarray(v))
        return np.asarray(unpack_i4(q4), np.float32) * np.asarray(s)[:, None]
    return v


@pytest.mark.parametrize("num_q", [1, 300])
@pytest.mark.parametrize("storage", STORAGES)
def test_device_route_against_stored_corpus(corpus, storage, num_q):
    """DeviceIndex alone: the route's returned scores are the exact dot of
    the query with each returned row as stored, and selection keeps the
    oracle's winners over that stored corpus."""
    rng = np.random.default_rng(5)
    dev = DeviceIndex(DIM, storage_dtype=storage)
    dev.full_upload(corpus, np.ones(N, bool))
    q = normalize_batch(corpus[rng.integers(0, N, num_q)] + 0.05 * rng.normal(
        size=(num_q, DIM)).astype(np.float32))
    vals, idxs = dev.query(q, 10)
    assert dev.last_strategy in ("xla_topk", "i8stor_xla", "i4stor_xla")
    stored = _stored(storage, corpus)
    qs = q
    if storage == "bfloat16":  # the bf16 route rounds the query too
        qs = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    want = np.einsum("qd,qkd->qk", qs.astype(np.float64),
                     stored[idxs].astype(np.float64))
    np.testing.assert_allclose(vals, want, atol=1e-5)
    o_ids, _ = _oracle(qs, stored, 10)
    recall = np.mean([len(set(idxs[i]) & set(o_ids[i, :10])) / 10
                      for i in range(num_q)])
    assert recall >= (0.99 if storage in ("float32", "bfloat16") else 0.9)


@pytest.mark.parametrize("case", ["underfill", "all_masked"])
@pytest.mark.parametrize("storage", STORAGES)
def test_underfill_and_all_masked(corpus, storage, case):
    """Fewer candidates than k: the missing entries carry -inf; no
    candidate at all: every entry is -inf."""
    dev = DeviceIndex(DIM, storage_dtype=storage)
    dev.full_upload(corpus, np.ones(N, bool))
    mask = np.zeros(N, bool)
    if case == "underfill":
        mask[[3, 500, 1999]] = True
    vals, idxs = dev.query(corpus[:4], 10, filter_mask=mask)
    finite = np.isfinite(vals)
    if case == "underfill":
        assert finite.sum(axis=1).tolist() == [3] * 4
        assert all(set(idxs[i][finite[i]]) == {3, 500, 1999}
                   for i in range(4))
    else:
        assert not finite.any()


@pytest.mark.parametrize("num_q", [1, 33])
@pytest.mark.parametrize("storage", STORAGES)
def test_blocked_matches_dense(corpus, storage, num_q, monkeypatch):
    """A device budget too small for the (Q, rows) temporaries walks the
    corpus in row blocks; the ids equal the dense form's and the scores
    agree to the last bits."""
    q = corpus[:num_q]
    dev = DeviceIndex(DIM, storage_dtype=storage)
    dev.full_upload(corpus, np.ones(N, bool))
    dv, di = dev.query(q, 10)
    assert not dev.last_strategy.endswith("_blocked")
    per = ex.scan_bytes_per_row(num_q, "f32", DIM)
    # room for ~1.5 blocks of MIN_SCAN_BLOCK rows, far below cap rows
    monkeypatch.setenv("PICOVDB_DEVICE_MEMORY_MB",
                       str(1.5 * ex.MIN_SCAN_BLOCK * per / 2**20 / 0.9))
    bv, bi = dev.query(q, 10)
    assert dev.last_strategy.endswith("_blocked")
    np.testing.assert_array_equal(bi, di)
    # same products, another GEMM shape: last-bit differences only
    np.testing.assert_allclose(bv, dv, rtol=0, atol=1e-6)


def test_blocked_topk_uneven_rows():
    """Rows not a multiple of the block: the slid last block masks the rows
    an earlier block already covered (no duplicates, none missed)."""
    rng = np.random.default_rng(3)
    v = normalize_batch(rng.normal(size=(2500, 16)).astype(np.float32))
    q = normalize_batch(rng.normal(size=(5, 16)).astype(np.float32))
    mask = rng.random(2500) > 0.3
    dense = ex.exact_topk(q, v, mask, 12)
    blocked = ex.exact_topk(q, v, mask, 12, block=1024)
    np.testing.assert_array_equal(np.asarray(blocked[1]),
                                  np.asarray(dense[1]))
    np.testing.assert_allclose(np.asarray(blocked[0]),
                               np.asarray(dense[0]), rtol=0, atol=1e-6)


def _f32_dots(jaxpr):
    """(precision, lhs dtype, rhs dtype) of every dot_general, recursing
    into sub-jaxprs (jit, scan, shard_map, ...)."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append((eqn.params["precision"], eqn.invars[0].aval.dtype,
                        eqn.invars[1].aval.dtype))
        for sub in jax.core.jaxprs_in_params(eqn.params):
            out.extend(_f32_dots(sub))
    return out


def _is_highest(precision):
    hi = jax.lax.Precision.HIGHEST
    if isinstance(precision, tuple):
        return all(p == hi for p in precision)
    return precision == hi


def _route_jaxprs():
    rng = np.random.default_rng(0)
    v = normalize_batch(rng.normal(size=(256, 32)).astype(np.float32))
    q = v[:4]
    m = np.ones(256, bool)
    idx = np.zeros((4, 5), np.int32)
    vals = np.zeros((4, 5), np.float32)
    v8, s8 = quantize_rows_i8(v)
    v4, s4 = quantize_rows_i4(v)
    from picovdb_tpu.ops import quant

    return {
        "exact": lambda: jax.make_jaxpr(ex.make_exact_topk(5))(q, v, m),
        "exact_blocked": lambda: jax.make_jaxpr(
            ex.make_exact_topk(5, block=64))(q, v, m),
        "approx": lambda: jax.make_jaxpr(ex.make_approx_topk(5))(q, v, m),
        "rescore": lambda: jax.make_jaxpr(quant.rescore_exact)(
            q, v, vals, idx),
        "rescore_i8r": lambda: jax.make_jaxpr(quant.rescore_exact_i8r)(
            q, v8, s8, vals, idx),
        "rescore_i4r": lambda: jax.make_jaxpr(quant.rescore_exact_i4r)(
            q, v4, s4, vals, idx),
    }


@pytest.mark.parametrize("route", sorted(_route_jaxprs()))
def test_f32_scoring_dots_use_highest(route):
    """Every float32 x float32 dot that ranks or returns scores states
    Precision.HIGHEST (a default-precision f32 dot may run in TF32)."""
    dots = _f32_dots(_route_jaxprs()[route]().jaxpr)
    f32 = [d for d in dots if d[1] == jnp.float32 and d[2] == jnp.float32]
    assert f32, "route has no f32 dot to check"
    assert all(_is_highest(p) for p, _, _ in f32), f32


def test_ivf_and_sharded_dots_use_highest():
    """The IVF probe (centroid scores, hot-tile scan, rescore) and the
    sharded exact body state HIGHEST on every f32 dot too."""
    from picovdb_tpu.ops.ivf import IVFIndex, _make_ivf_search
    from picovdb_tpu.parallel import make_mesh
    from picovdb_tpu.parallel.sharded_query import make_sharded_topk

    rng = np.random.default_rng(1)
    v = normalize_batch(rng.normal(size=(2048, 32)).astype(np.float32))
    ivf = IVFIndex.build(v, np.ones(2048, bool), nlist=8, dim=32)
    fn = _make_ivf_search(5, 8, 8, None, ivf.n_tiles)
    jp = jax.make_jaxpr(fn)(
        v[:8], ivf.centroids, ivf.vectors, ivf.slots, ivf.seg_starts,
        ivf.active, ivf.cluster2tile)
    dots = [d for d in _f32_dots(jp.jaxpr) if d[1] == d[2] == jnp.float32]
    assert len(dots) >= 3 and all(_is_highest(d[0]) for d in dots), dots
    mesh = make_mesh()
    sh = make_sharded_topk(mesh, "shard", 5)
    jp = jax.make_jaxpr(sh)(v[:8], v, np.ones(2048, bool))
    dots = [d for d in _f32_dots(jp.jaxpr) if d[1] == d[2] == jnp.float32]
    assert dots and all(_is_highest(d[0]) for d in dots), dots


@pytest.mark.parametrize("layout", ["float32", "int8_only"])
def test_ivf_full_nprobe_equals_exact(layout, monkeypatch):
    """The XLA IVF probe at full nprobe returns the exact route's ids."""
    from picovdb_tpu.ops.ivf import IVFIndex

    rng = np.random.default_rng(4)
    dim = 256  # int8 postings need dim >= IVF_I8_MIN_DIM
    v = _corpus(rng, n=3000, dim=dim, centers=24)
    q = v[rng.integers(0, 3000, 16)] + 0.02 * rng.normal(
        size=(16, dim)).astype(np.float32)
    dev = DeviceIndex(dim)
    dev.full_upload(v, np.ones(3000, bool))
    ivf = IVFIndex.build(v, np.ones(3000, bool), nlist=16, dim=dim,
                         i8_only=layout == "int8_only")
    assert (ivf.vectors is None) == (layout == "int8_only")
    vals, slots = ivf.search(normalize_batch(q), 10, ef=10**6, dev=dev)
    ev, ei = dev.query(q, 10)
    np.testing.assert_array_equal(slots, ei)
    np.testing.assert_allclose(vals, ev, atol=1e-5)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, monkeypatch, tmp_path):
    """JAX_COMPILATION_CACHE_DIR set: the engine sets no directory (JAX
    reads the variable itself). Unset: the cache goes to the checkout's
    .jax_cache, which .gitignore lists."""
    import os

    from picovdb_tpu import engine

    old = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        engine._maybe_enable_compile_cache()
        got = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    if env_set:
        assert got is None
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache")
        with open(os.path.join(repo, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize("mode", ["fused", "mixed"])
def test_removed_scan_modes_raise(tmp_path, mode):
    with pytest.raises(ValueError, match=mode):
        PicoVectorDB(embedding_dim=8, storage_file=str(tmp_path / "db"),
                     scan_mode=mode)


@pytest.mark.parametrize("kwarg", ["use_pallas", "mixed_precision",
                                   "int8_tier"])
def test_removed_kernel_options_rejected(tmp_path, kwarg):
    with pytest.raises(TypeError, match=kwarg):
        PicoVectorDB(embedding_dim=8, storage_file=str(tmp_path / "db"),
                     **{kwarg: True})


class _StubDevice:
    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


@pytest.mark.parametrize("stats,env,limit", [
    ({"bytes_limit": 10**9, "bytes_in_use": 3 * 10**8}, None, 9 * 10**8),
    ({"bytes_limit": 10**9, "bytes_in_use": 95 * 10**7}, None, 9 * 10**8),
    (None, None, None),
    (None, "1", int(2**20 * 0.9)),
])
def test_budget_from_memory_stats(monkeypatch, corpus, stats, env, limit):
    """The limit is the device's bytes_limit less the stated headroom (or
    the override); a dispatch's budget is that limit less the store's
    resident planes, shared by the dispatch slots, whatever bytes_in_use
    says; no stats and no override: no bound."""
    from picovdb_tpu import utils

    if env is None:
        monkeypatch.delenv(utils.ENV_DEVICE_MEMORY_MB, raising=False)
    else:
        monkeypatch.setenv(utils.ENV_DEVICE_MEMORY_MB, env)
    monkeypatch.setattr(utils, "_memory_stats", lambda device: stats)
    assert utils.device_memory_limit(_StubDevice(stats)) == limit
    dev = DeviceIndex(DIM)
    dev.full_upload(corpus, np.ones(N, bool))
    if limit is None:
        assert dev.temp_budget() is None
        return
    resident = (dev.cap * DIM * 4 + dev.cap
                + dev.MASK_CACHE_MAX * dev.cap)
    assert dev.temp_budget() == max(0, limit - resident) \
        // utils.DISPATCH_SLOTS
    dev.ann_bytes = 1000  # postings count against it too
    assert dev.temp_budget() == max(0, limit - resident - 1000) \
        // utils.DISPATCH_SLOTS


def test_concurrent_readers_keep_route_and_budget(corpus, monkeypatch):
    """Readers dispatching at once while the bytes in use swing: each query
    shape always takes one route, and no more than DISPATCH_SLOTS
    dispatches hold temporaries at once, each within its share, so
    together they stay under the limit."""
    import itertools
    import threading
    import time

    from picovdb_tpu import device as device_mod
    from picovdb_tpu import utils

    swing = itertools.cycle([0, 30 * 2**20, 60 * 2**20])
    monkeypatch.delenv(utils.ENV_DEVICE_MEMORY_MB, raising=False)
    monkeypatch.setattr(utils, "_memory_stats", lambda device: {
        "bytes_limit": 64 * 2**20, "bytes_in_use": next(swing)})
    real = device_mod.make_exact_topk
    held = {"now": 0, "most": 0, "bytes": 0, "most_bytes": 0}
    lock = threading.Lock()

    def counting(k, compute_dtype=None, normalize=True, block=None):
        fn = real(k, compute_dtype, normalize=normalize, block=block)

        def run(q, v, m):
            temp = ex.scan_bytes_per_row(q.shape[0], "f32", DIM) * (
                block or v.shape[0])
            with lock:
                held["now"] += 1
                held["bytes"] += temp
                held["most"] = max(held["most"], held["now"])
                held["most_bytes"] = max(held["most_bytes"], held["bytes"])
            try:
                time.sleep(0.002)
                return fn(q, v, m)
            finally:
                with lock:
                    held["now"] -= 1
                    held["bytes"] -= temp
        return run

    monkeypatch.setattr(device_mod, "make_exact_topk", counting)
    dev = DeviceIndex(DIM)
    dev.full_upload(corpus, np.ones(N, bool))
    queries = {1: corpus[:1], 300: corpus[:300]}
    want = {nq: dev.query(q, 10)[1] for nq, q in queries.items()}
    seen = []

    def reader():
        for nq in (1, 300) * 3:
            _, idx = dev.query(queries[nq], 10)
            seen.append((nq, dev.last_strategy, np.array_equal(idx,
                                                               want[nq])))

    threads = [threading.Thread(target=reader) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(seen) == 24 and all(ok for _, _, ok in seen)
    # Q=1 fits its share dense; Q=300 (512 padded) walks row blocks
    assert {(nq, s) for nq, s, _ in seen} == {
        (1, "xla_topk"), (300, "xla_topk_blocked")}
    budget = dev.temp_budget()
    assert held["most"] <= utils.DISPATCH_SLOTS
    assert held["most_bytes"] <= utils.DISPATCH_SLOTS * budget
    assert utils.DISPATCH_SLOTS * budget <= utils.device_memory_limit(None)


@pytest.mark.parametrize("path", ["upsert", "ingest_device"])
@pytest.mark.parametrize("large", [False, True])
def test_auto_index_builds_and_warms_only_when_large(tmp_path, corpus,
                                                     monkeypatch, path,
                                                     large):
    """index="auto": syncing a store below the build threshold neither
    builds the IVF tier nor warms the mutation path, on either load path;
    above it, the first query builds (and then warms) it."""
    from picovdb_tpu.ops import ivf as ivf_mod

    monkeypatch.setattr(ivf_mod, "should_build",
                        lambda n, dim=None, itemsize=4.0: large)
    monkeypatch.setenv("PICOVDB_WARM_UPDATES", "1")
    warms = []
    monkeypatch.setattr(DeviceIndex, "warm_scatter_path",
                        lambda self, bucket=1024: warms.append(bucket))
    db = PicoVectorDB(embedding_dim=DIM, storage_file=str(tmp_path / "db"),
                      index="auto")
    ids = [str(i) for i in range(N - 100)]
    if path == "upsert":
        db.upsert_columnar(corpus[: N - 100].copy(), ids=ids)
    else:
        db.ingest_device(jnp.asarray(corpus[: N - 100]), ids=ids)
    db.query(corpus[0], top_k=5)
    db.upsert_columnar(corpus[N - 100:].copy(),
                       ids=[str(i) for i in range(N - 100, N)])
    hit = db.query(corpus[N - 1], top_k=1)
    assert hit[0][K_ID] == str(N - 1)
    assert (db._ivf is not None) == large
    assert bool(warms) == large
    assert (db._dev.ann_bytes > 0) == large


@pytest.mark.parametrize("free,want", [
    (None, None),                      # no bound known: dense
    (10**12, None),                    # fits: dense
    (3 * 1024 * 8 * 4, 2048),          # ~3k rows fit: pow2 floor
    (1, ex.MIN_SCAN_BLOCK),            # floor at MIN_SCAN_BLOCK
])
def test_scan_block_choice(free, want):
    assert ex.scan_block(1 << 16, 4, "f32", 64, free) == want


def test_ivf_budget_reads_device_limit(tmp_path, monkeypatch):
    """The IVF layout budget is the device memory limit (no constant): a
    tiny limit picks the int8-only layout, an ample one the classic."""
    monkeypatch.setenv("PICOVDB_DEVICE_MEMORY_MB", "0.01")
    db = PicoVectorDB(embedding_dim=256, storage_file=str(tmp_path / "a"),
                      storage_dtype="bfloat16")
    db.upsert_columnar(_corpus(np.random.default_rng(2), n=512, dim=256),
                       ids=[str(i) for i in range(512)])
    assert db._ivf_budget_bytes() == int(0.01 * 2**20 * 0.9)
    assert db._ivf_i8_only()
    monkeypatch.setenv("PICOVDB_DEVICE_MEMORY_MB", str(64 * 1024))
    assert not db._ivf_i8_only()
