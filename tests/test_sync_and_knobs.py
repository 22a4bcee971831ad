"""Device-mirror synchronization (lazy, incremental vs full) and tuning knobs.

Analogs of the reference's FAISS lazy-rebuild tests
(tests/test_task12_faiss_dirty_flag.py, test_task36_faiss_incremental_threshold.py)
and knob-precedence tests (test_task48_tuning_knobs.py): the device mirror
plays the role the FAISS index played.
"""

import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR
from picovdb_tpu.constants import ADAPTIVE_BUFFER
from conftest import make_items


def test_sync_exactly_once_per_dirty_epoch(db_path, rng, monkeypatch):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, vecs = make_items(rng, 20, 8)
    db.upsert(items)
    assert db._dirty

    calls = {"n": 0}
    orig = db._sync_device_locked

    def spy():
        calls["n"] += 1
        orig()

    monkeypatch.setattr(db, "_sync_device_locked", spy)
    db.query(vecs[0])
    assert calls["n"] == 1
    assert not db._dirty
    db.query(vecs[1])
    db.query(vecs[2])
    assert calls["n"] == 1  # clean epoch: no further syncs
    db.delete(["id0"])
    assert db._dirty
    db.query(vecs[3])
    assert calls["n"] == 2


def test_incremental_vs_full_threshold(db_path, rng):
    db = PicoVectorDB(
        embedding_dim=8, storage_file=db_path, faiss_incremental_threshold_ratio=0.2
    )
    items, vecs = make_items(rng, 100, 8)
    db.upsert(items)
    db.query(vecs[0])
    assert db._last_sync_mode == "full"  # first upload

    # small change set -> incremental scatter
    v = rng.normal(size=8).astype(np.float32)
    db.upsert([{K_ID: "id0", K_VECTOR: v}])
    db.query(vecs[0])
    assert db._last_sync_mode == "incremental"

    # large change set (>20%) -> full upload
    big = [
        {K_ID: f"id{i}", K_VECTOR: rng.normal(size=8).astype(np.float32)}
        for i in range(40)
    ]
    db.upsert(big)
    db.query(vecs[0])
    assert db._last_sync_mode == "full"


def test_incremental_sync_correctness(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, vecs = make_items(rng, 50, 8)
    db.upsert(items)
    db.query(vecs[0])  # establish mirror
    # update one vector to point at a new direction; delete another
    target = rng.normal(size=8).astype(np.float32)
    db.upsert([{K_ID: "id10", K_VECTOR: target}])
    db.delete(["id11"])
    res = db.query(target, top_k=2)
    assert res[0][K_ID] == "id10"
    assert db._last_sync_mode == "incremental"
    assert all(r[K_ID] != "id11" for r in res)


def test_adaptive_buffer_kwarg_env_precedence(db_path, monkeypatch):
    monkeypatch.setenv("PICOVDB_ADAPTIVE_BUFFER", "7")
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    assert db._adaptive_buffer == 7
    db2 = PicoVectorDB(embedding_dim=8, storage_file=db_path + "b", adaptive_buffer=3)
    assert db2._adaptive_buffer == 3
    monkeypatch.delenv("PICOVDB_ADAPTIVE_BUFFER")
    db3 = PicoVectorDB(embedding_dim=8, storage_file=db_path + "c")
    assert db3._adaptive_buffer == ADAPTIVE_BUFFER


def test_argsort_threshold_knob_accepted(db_path, monkeypatch):
    monkeypatch.setenv("PICOVDB_ARGSORT_THRESHOLD", "0.5")
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    assert db._argsort_threshold == 0.5
    db2 = PicoVectorDB(
        embedding_dim=8, storage_file=db_path + "b", argsort_threshold=0.9
    )
    assert db2._argsort_threshold == 0.9


def test_last_k_eff_reflects_filters(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path, adaptive_buffer=4)
    items, vecs = make_items(rng, 30, 8, extra=lambda i: {"tag": i % 2})
    db.upsert(items)
    db.query(vecs[0], top_k=5)
    assert db._last_k_eff == 5  # unfiltered: k_eff == top_k
    # dict filters are exact device-side masks: no over-fetch needed
    db.query(vecs[0], top_k=5, where={"tag": 0})
    assert db._last_k_eff == 5
    # callable where is re-applied during assembly -> adaptive buffer
    db.query(vecs[0], top_k=5, where=lambda d: d["tag"] == 0)
    assert db._last_k_eff == 9  # top_k + adaptive_buffer
    db.query(vecs[0], top_k=5, ids=["id1", "id2", "id3"])
    assert db._last_k_eff == 3  # clamped to candidate count


def test_last_topk_strategy_recorded(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, vecs = make_items(rng, 10, 8)
    db.upsert(items)
    db.query(vecs[0])
    assert db._last_topk_strategy in (
        "xla_topk",
        "sharded_scan",
        "ivf",
    )


def test_filters_fill_top_k_under_adaptive_buffer(db_path, rng):
    """With a filter that keeps half the corpus, top_k results still fill."""
    db = PicoVectorDB(embedding_dim=16, storage_file=db_path)
    items, vecs = make_items(rng, 80, 16, extra=lambda i: {"tag": i % 2})
    db.upsert(items)
    res = db.query(vecs[0], top_k=10, where={"tag": 0})
    assert len(res) == 10
    assert all(r["tag"] == 0 for r in res)


def test_compat_knobs_accepted(db_path):
    """Reference-only FAISS knobs are accepted without error."""
    db = PicoVectorDB(
        embedding_dim=8,
        storage_file=db_path,
        no_faiss=True,
        faiss_threads=2,
        hnsw_m=16,
        hnsw_ef_construction=100,
        ef_search_default=64,
        hnsw_ef_search_default=96,
    )
    assert db._ef_search == 96  # new name wins over legacy
    assert db._index_kind == "exact"  # no_faiss disables the ANN tier
    db2 = PicoVectorDB(
        embedding_dim=8, storage_file=db_path + "b", ef_search_default=48
    )
    assert db2._ef_search == 48


def test_last_query_debug(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, vecs = make_items(rng, 10, 8)
    db.upsert(items)
    db.query(vecs[0], top_k=3)
    dbg = db.last_query_debug()
    assert dbg["strategy"] in ("xla_topk", "sharded_scan", "ivf", "ivf_i8")
    assert dbg["k_eff"] == 3
    assert dbg["sync_mode"] in ("full", "incremental")
    assert dbg["dirty"] is False
    assert dbg["scan_mode"] == "auto"


def test_ivf_nprobe_ctor_override(db_path, rng):
    """ivf_nprobe pins the probe width regardless of ef knobs."""
    centers = rng.normal(size=(8, 16)).astype(np.float32)
    vecs = (centers[rng.integers(0, 8, 300)]
            + 0.1 * rng.normal(size=(300, 16))).astype(np.float32)
    db = PicoVectorDB(
        embedding_dim=16, storage_file=db_path, index="ivf",
        ivf_nlist=8, ivf_nprobe=8,  # probe everything -> exact
    )
    db.upsert([{K_ID: f"x{i}", K_VECTOR: vecs[i]} for i in range(300)])
    res = db.query(vecs[33], top_k=1, ef_search=1)
    assert res[0][K_ID] == "x33"
    assert db._last_topk_strategy.startswith("ivf")


def test_ivf_engine_plain_cpu_no_interpret_ctx(db_path, rng):
    """index="ivf" must work on a plain CPU backend with no special setup
    (a CPU user of the reference can set index="ivf" and expect it to
    run, pico_vdb.py:171)."""
    centers = rng.normal(size=(8, 16)).astype(np.float32)
    vecs = (centers[rng.integers(0, 8, 300)]
            + 0.1 * rng.normal(size=(300, 16))).astype(np.float32)
    db = PicoVectorDB(
        embedding_dim=16, storage_file=db_path, index="ivf", ivf_nlist=8,
    )
    db.upsert([{K_ID: f"x{i}", K_VECTOR: vecs[i]} for i in range(300)])
    res = db.query(vecs[33], top_k=1, ef_search=64)
    assert res[0][K_ID] == "x33"
    assert db._last_topk_strategy.startswith("ivf")


def test_hnsw_construction_knobs_drive_ivf_build(db_path, rng):
    """hnsw_m scales nlist, hnsw_ef_construction scales k-means iters
    (the reference builds its index with both, pico_vdb.py:171-176);
    explicit ivf_nlist wins; the resolved point is observable in
    last_query_debug()."""
    from picovdb_tpu.ops.ivf import default_nlist

    centers = rng.normal(size=(8, 16)).astype(np.float32)
    vecs = (centers[rng.integers(0, 8, 400)]
            + 0.1 * rng.normal(size=(400, 16))).astype(np.float32)
    items = [{K_ID: f"x{i}", K_VECTOR: vecs[i]} for i in range(400)]

    # doubled hnsw_m -> doubled nlist vs the default rule
    db = PicoVectorDB(
        embedding_dim=16, storage_file=db_path, index="ivf",
        hnsw_m=64, hnsw_ef_construction=80,
    )
    db.upsert(items)
    db.query(vecs[0], top_k=1)
    dbg = db.last_query_debug()
    bp = dbg["ann_build_params"]
    assert bp["hnsw_m"] == 64 and bp["hnsw_ef_construction"] == 80
    assert bp["kmeans_iters"] == 16  # 8 * 80/40
    expect_nlist = min(round(default_nlist(400) * 64 / 32), 400)
    assert dbg["ann_operating_point"]["nlist"] == expect_nlist

    # explicit ivf_nlist beats the hnsw_m scaling
    db2 = PicoVectorDB(
        embedding_dim=16, storage_file=db_path + "b", index="ivf",
        hnsw_m=64, ivf_nlist=8,
    )
    db2.upsert(items)
    db2.query(vecs[0], top_k=1)
    dbg2 = db2.last_query_debug()
    assert dbg2["ann_operating_point"]["nlist"] == 8
    assert dbg2["ann_build_params"]["nlist_requested"] == 8

    # default knobs -> default build (iters 8, default nlist rule)
    db3 = PicoVectorDB(
        embedding_dim=16, storage_file=db_path + "c", index="ivf",
    )
    db3.upsert(items)
    db3.query(vecs[0], top_k=1)
    bp3 = db3.last_query_debug()["ann_build_params"]
    assert bp3["kmeans_iters"] == 8 and bp3["nlist_requested"] is None


def test_device_grow_keeps_append_epoch_incremental(db_path, rng):
    """Appends that cross a ROW_PAD capacity bucket grow the device planes
    in place (d2d pad) instead of falling back to a host-fed full
    re-upload — on lazy capacity-tier stores the fallback materializes
    the whole f32 host matrix (measured OOM at 8M x 1024 int4+IVF,
    bench/results/ivf8m_i4_incr_r5.log)."""
    import jax.numpy as jnp

    from picovdb_tpu.constants import ROW_PAD

    dim, n = 8, ROW_PAD - 50
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path)
    db.ingest_device(jnp.asarray(vecs), ids=[str(i) for i in range(n)],
                     normalize=False)
    assert db._host_lazy and db._dev.cap == ROW_PAD
    db.query(vecs[0])

    extra = rng.normal(size=(100, dim)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    db.upsert([{K_ID: f"x{i}", K_VECTOR: extra[i]} for i in range(100)])
    res = db.query(extra[3], top_k=1)
    assert res[0][K_ID] == "x3"
    assert db._last_sync_mode == "incremental"  # not a full re-upload
    assert db._dev.cap > ROW_PAD
    assert db._host_lazy  # the fallback would have materialized
    # pre-grow rows still served, actives consistent
    assert db.query(vecs[7], top_k=1)[0][K_ID] == "7"
    assert db.count() == n + 100


def test_device_grow_quantized_store(db_path, rng):
    """Same bucket-crossing append on an int8 store: the packed plane and
    the per-row scale column grow together."""
    import jax.numpy as jnp

    from picovdb_tpu.constants import ROW_PAD

    dim, n = 16, ROW_PAD - 10
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path,
                      storage_dtype="int8")
    db.ingest_device(jnp.asarray(vecs), ids=[str(i) for i in range(n)],
                     normalize=False)
    db.query(vecs[0])
    cap0 = db._dev.cap

    extra = rng.normal(size=(40, dim)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    db.upsert([{K_ID: f"x{i}", K_VECTOR: extra[i]} for i in range(40)])
    assert db.query(extra[0], top_k=1)[0][K_ID] == "x0"
    assert db._last_sync_mode == "incremental"
    assert db._dev.cap > cap0
    assert db._dev.vstore_scale.shape[0] == db._dev.cap
    assert db._host_lazy
    assert db.query(vecs[5], top_k=1)[0][K_ID] == "5"
