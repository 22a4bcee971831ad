"""IVF-flat ANN tier: k-means layout, probed search, engine integration.

Differential strategy mirrors the reference's FAISS-vs-NumPy parity test
(tests/test_task14_faiss_vs_numpy_results.py): the ANN tier must match the
exact path at high recall on clusterable data, degrade gracefully at low
nprobe, persist and reload through the sidecar, and respect the ef_search
knob mapping.
"""

import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR
from picovdb_tpu.ops.ivf import IVFIndex, default_nlist, ef_to_nprobe
from picovdb_tpu.utils import normalize_batch
from conftest import make_items


def clustered_data(rng, n, dim, n_clusters=16, spread=0.15):
    """Synthetic clusterable corpus (random data doesn't cluster in high dim)."""
    centers = normalize_batch(
        rng.normal(size=(n_clusters, dim)).astype(np.float32)
    )
    labels = rng.integers(0, n_clusters, size=n)
    pts = centers[labels] + spread * rng.normal(size=(n, dim)).astype(np.float32)
    return normalize_batch(pts), labels


def test_ivf_build_and_exact_recall(rng):
    n, dim, k = 3000, 64, 10
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    ivf = IVFIndex.build(vectors, mask, nlist=32, dim=dim)

    queries = vectors[:16] + 0.01 * rng.normal(size=(16, dim)).astype(np.float32)
    vals, slots = ivf.search(normalize_batch(queries), k, ef=64, dev=None)
    assert vals.shape == (16, k) and slots.shape == (16, k)

    # oracle over the full corpus
    scores = normalize_batch(queries) @ vectors.T
    oidx = np.argsort(-scores, axis=1)[:, :k]
    recall = np.mean(
        [len(set(slots[i]) & set(oidx[i])) / k for i in range(16)]
    )
    assert recall >= 0.9, recall  # ef=64 -> nprobe=32 = all lists -> exact


def test_ivf_nprobe_tradeoff(rng):
    n, dim, k = 3000, 64, 5
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    ivf = IVFIndex.build(vectors, mask, nlist=32, dim=dim)
    queries = normalize_batch(
        vectors[:8] + 0.01 * rng.normal(size=(8, dim)).astype(np.float32)
    )
    scores = queries @ vectors.T
    oidx = np.argsort(-scores, axis=1)[:, :k]

    recalls = {}
    for ef in (2, 64):
        vals, slots = ivf.search(queries, k, ef=ef, dev=None)
        recalls[ef] = np.mean(
            [len(set(slots[i]) & set(oidx[i])) / k for i in range(8)]
        )
    assert recalls[64] >= recalls[2]
    assert recalls[64] >= 0.9


def test_ivf_respects_active_mask(rng):
    n, dim = 1000, 32
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    mask[::2] = False  # half deleted
    ivf = IVFIndex.build(vectors, mask, nlist=8, dim=dim)
    q = normalize_batch(vectors[1][None])
    vals, slots = ivf.search(q, 20, ef=16, dev=None)
    live = slots[0][np.isfinite(vals[0])]
    assert all(s % 2 == 1 for s in live), live  # only odd (active) slots


def test_ef_to_nprobe_mapping():
    assert ef_to_nprobe(2, 100) == 1
    assert ef_to_nprobe(32, 100) == 16
    assert ef_to_nprobe(10_000, 100) == 100
    assert default_nlist(100_000) == int(2 * np.sqrt(100_000))


def test_engine_ivf_integration(db_path, rng):
    dim = 32
    vectors, labels = clustered_data(rng, 600, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    db.upsert(
        [
            {K_ID: f"id{i}", K_VECTOR: vectors[i], "c": int(labels[i])}
            for i in range(600)
        ]
    )
    res = db.query(vectors[42], top_k=5, hnsw_ef_search=16)
    assert db._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "id42"

    # filtered queries bypass the ANN tier for exactness (same policy as the
    # reference's faiss_ok gate, picovdb/pico_vdb.py:667-668)
    resf = db.query(vectors[42], top_k=5, where={"c": int(labels[42])})
    assert not db._last_topk_strategy.startswith("ivf")
    assert all(r["c"] == int(labels[42]) for r in resf)

    # deletions are respected after the lazy resync
    db.delete(["id42"])
    res2 = db.query(vectors[42], top_k=5)
    assert all(r[K_ID] != "id42" for r in res2)


def test_engine_ivf_sidecar_roundtrip(db_path, rng):
    dim = 32
    vectors, _ = clustered_data(rng, 400, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    db.upsert([{K_ID: f"id{i}", K_VECTOR: vectors[i]} for i in range(400)])
    db.query(vectors[0], top_k=1)  # force sync + ANN build
    db.save()
    import os

    assert os.path.exists(db_path + ".vecs.npy.ivf.npz")

    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    assert db2._ivf is not None  # loaded from sidecar, no retrain
    res = db2.query(vectors[7], top_k=1)
    assert res[0][K_ID] == "id7"
    assert db2._last_topk_strategy.startswith("ivf")


def test_corrupt_sidecar_triggers_rebuild(db_path, rng):
    """Corrupt/missing ANN sidecar self-heals, like the reference's FAISS
    load fallback (tests/test_task15_faiss_persist_load_safely.py)."""
    dim = 32
    vectors, _ = clustered_data(rng, 300, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    db.upsert([{K_ID: f"id{i}", K_VECTOR: vectors[i]} for i in range(300)])
    db.query(vectors[0], top_k=1)
    db.save()
    with open(db_path + ".vecs.npy.ivf.npz", "wb") as f:
        f.write(b"garbage not a zipfile")
    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    res = db2.query(vectors[3], top_k=1)
    assert res[0][K_ID] == "id3"


def test_stale_sidecar_after_mutation_retrains(db_path, rng):
    dim = 32
    vectors, _ = clustered_data(rng, 200, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    db.upsert([{K_ID: f"id{i}", K_VECTOR: vectors[i]} for i in range(200)])
    db.query(vectors[0], top_k=1)
    db.save()
    # mutate the store files out-of-band: delete an id from ids/meta
    import json as _json

    ids = _json.load(open(db_path + ".ids.json"))
    meta = _json.load(open(db_path + ".meta.json"))
    meta["data"][5] = None
    _json.dump(ids, open(db_path + ".ids.json", "w"))
    _json.dump(meta, open(db_path + ".meta.json", "w"))
    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    assert db2.count() == 199
    res = db2.query(vectors[6], top_k=3)
    assert res[0][K_ID] == "id6"
    assert all(r[K_ID] != "id5" for r in res)


def test_ivf_empty_probe_falls_back_to_exact(rng):
    """All probed clusters empty -> exact-scan fallback, not empty results
    (ADVICE r1, low: n_hot==0 fed an out-of-range tile index)."""
    from picovdb_tpu.device import DeviceIndex

    n, dim, k = 1000, 32, 5
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    # Build with warm centroids pointing far away from the data and zero
    # refresh iterations, then delete every row of whatever cluster the
    # query would probe -- easier: build normally, then blank cluster2tile
    # so no tile is ever hot.
    ivf = IVFIndex.build(vectors, mask, nlist=8, dim=dim)
    import jax.numpy as jnp

    ivf.cluster2tile = jnp.zeros_like(ivf.cluster2tile)
    dev = DeviceIndex(dim)
    dev.full_upload(vectors, mask)
    q = normalize_batch(vectors[3][None])
    vals, slots = ivf.search(q, k, ef=2, dev=dev)
    assert np.isfinite(vals[0]).all()
    assert slots[0][0] == 3


def test_ivf_incremental_update_no_retrain(db_path, rng):
    """1% mutations with IVF active must NOT retrain/reorder (VERDICT r1):
    touched rows move to the always-probed overflow region in place."""
    dim = 32
    vectors, labels = clustered_data(rng, 800, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    db.upsert([{K_ID: f"id{i}", K_VECTOR: vectors[i]} for i in range(800)])
    db.query(vectors[0], top_k=1)  # initial build
    assert db._last_ann_rebuild_mode == "full"

    # small mutation set: 4 updates + 4 inserts + 2 deletes (~1%)
    newv = normalize_batch(
        rng.normal(size=(8, dim)).astype(np.float32)
    )
    db.delete(["id10", "id11"])
    db.upsert(
        [{K_ID: f"id{i}", K_VECTOR: newv[j]} for j, i in enumerate(range(4))]
        + [{K_ID: f"new{j}", K_VECTOR: newv[4 + j]} for j in range(4)]
    )
    res = db.query(newv[5], top_k=3)
    assert db._last_ann_rebuild_mode == "incremental"
    assert db._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "new1"
    # updated vector is served from the overflow region
    res2 = db.query(newv[0], top_k=3)
    assert res2[0][K_ID] == "id0"
    # deleted rows never surface
    res3 = db.query(vectors[10], top_k=10)
    assert all(r[K_ID] not in ("id10", "id11") for r in res3)
    # old (pre-update) vector of id0 must not shadow the new one
    res4 = db.query(vectors[0], top_k=10)
    ids4 = [r[K_ID] for r in res4]
    assert ids4.count("id0") <= 1

    # a big mutation set crosses the threshold -> full rebuild
    manyv = normalize_batch(
        rng.normal(size=(400, dim)).astype(np.float32)
    )
    db.upsert(
        [{K_ID: f"bulk{j}", K_VECTOR: manyv[j]} for j in range(400)]
    )
    db.query(manyv[0], top_k=1)
    assert db._last_ann_rebuild_mode == "full"


def test_ivf_build_from_device_mirror_parity(rng):
    """Build from an HBM-resident mirror (dev_vectors) must match the
    host-matrix build: same centroids seed, same layout, same results."""
    import jax

    n, dim, k = 2000, 64, 8
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    mask[7] = False
    host_ivf = IVFIndex.build(vectors, mask, nlist=16, dim=dim, seed=3)
    dev_ivf = IVFIndex.build(
        None, mask, nlist=16, dim=dim, seed=3,
        dev_vectors=jax.device_put(vectors),
    )
    queries = normalize_batch(
        vectors[:8] + 0.01 * rng.normal(size=(8, dim)).astype(np.float32)
    )
    hv, hs = host_ivf.search(queries, k, ef=64, dev=None)
    dv, ds = dev_ivf.search(queries, k, ef=64, dev=None)
    np.testing.assert_array_equal(hs, ds)
    np.testing.assert_allclose(hv, dv, rtol=1e-5, atol=1e-6)
    assert 7 not in set(ds.ravel().tolist())


def test_ivf_bfloat16_mirror(rng):
    """bfloat16 storage: mirror keeps the dtype, search recall holds (the
    exact f32 rescore of probed winners bounds the quantization loss)."""
    import jax.numpy as jnp

    n, dim, k = 2000, 64, 10
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    ivf = IVFIndex.build(vectors, mask, nlist=16, dim=dim,
                         storage_dtype="bfloat16")
    assert ivf.vectors.dtype == jnp.bfloat16
    queries = normalize_batch(
        vectors[:8] + 0.01 * rng.normal(size=(8, dim)).astype(np.float32)
    )
    vals, slots = ivf.search(queries, k, ef=64, dev=None)
    scores = queries @ vectors.T
    oidx = np.argsort(-scores, axis=1)[:, :k]
    recall = np.mean(
        [len(set(slots[i]) & set(oidx[i])) / k for i in range(8)]
    )
    assert recall >= 0.9, recall


def test_ivf_incremental_sidecar_reload(db_path, rng):
    """Sidecar refreshed after incremental updates: reload reuses the
    trained centroids instead of a stale-sidecar retrain."""
    dim = 32
    vectors, _ = clustered_data(rng, 400, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    db.upsert([{K_ID: f"id{i}", K_VECTOR: vectors[i]} for i in range(400)])
    db.query(vectors[0], top_k=1)
    nv = normalize_batch(rng.normal(size=(1, dim)).astype(np.float32))
    db.upsert([{K_ID: "late", K_VECTOR: nv[0]}])
    db.query(vectors[0], top_k=1)
    assert db._last_ann_rebuild_mode == "incremental"
    db.save()
    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    assert db2._ivf is not None
    res = db2.query(nv[0], top_k=1)
    assert res[0][K_ID] == "late"


def test_ivf_segmax_style_recall(rng, monkeypatch):
    """Full-probe recall on large clusters (each spans many hot tiles and
    the batch probes every list): the gathered hot-tile scan surfaces the
    true top-k with exact rescored scores."""
    n, dim, k = 8192, 32, 10
    vectors, _ = clustered_data(rng, n, dim, n_clusters=8)
    mask = np.ones(n, dtype=bool)
    ivf = IVFIndex.build(vectors, mask, nlist=8, dim=dim)

    queries = normalize_batch(
        vectors[:16] + 0.01 * rng.normal(size=(16, dim)).astype(np.float32)
    )
    vals, slots = ivf.search(queries, k, ef=64, dev=None)  # nprobe = all
    scores = queries @ vectors.T
    oidx = np.argsort(-scores, axis=1)[:, :k]
    recall = np.mean(
        [len(set(slots[i]) & set(oidx[i])) / k for i in range(16)]
    )
    assert recall >= 0.9, recall
    # scores must be exact f32 (rescored), matching the oracle's values
    osc = np.take_along_axis(scores, oidx, axis=1)
    assert np.allclose(np.sort(vals, axis=1)[:, ::-1][:, :3],
                       np.sort(osc, axis=1)[:, ::-1][:, :3], atol=2e-3)


def test_ivf_segmax_guard_small_clusters(rng, monkeypatch):
    """Small clusters (many lists inside one tile, the regime where a
    per-segment extraction truncated winners): the probe keeps its whole
    k+guard band per query and recall stays high at full probe."""
    n, dim, k = 3000, 64, 10
    vectors, _ = clustered_data(rng, n, dim, n_clusters=32)
    mask = np.ones(n, dtype=bool)
    ivf = IVFIndex.build(vectors, mask, nlist=32, dim=dim)
    queries = normalize_batch(
        vectors[:16] + 0.01 * rng.normal(size=(16, dim)).astype(np.float32)
    )
    vals, slots = ivf.search(queries, k, ef=64, dev=None)
    scores = queries @ vectors.T
    oidx = np.argsort(-scores, axis=1)[:, :k]
    recall = np.mean(
        [len(set(slots[i]) & set(oidx[i])) / k for i in range(16)]
    )
    assert recall >= 0.9, recall


def test_ivf_int8_postings_parity(rng, monkeypatch):
    """The column-scaled int8 postings mirror selects the same winners as
    the storage-dtype sweep (exact rescore makes scores identical)."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # force below IVF_I8_MIN_DIM
    n, dim, k = 3000, 64, 10
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    queries = normalize_batch(
        vectors[:16] + 0.01 * rng.normal(size=(16, dim)).astype(np.float32)
    )

    ivf = IVFIndex.build(vectors, mask, nlist=32, dim=dim)
    assert ivf.vectors_i8c is not None  # mirror forced on via env
    v_i8, s_i8 = ivf.search(queries, k, ef=64, dev=None)

    ivf.vectors_i8c = None  # opt out -> storage-dtype sweep
    ivf.cscale = None
    v_f32, s_f32 = ivf.search(queries, k, ef=64, dev=None)

    overlap = np.mean([
        len(set(s_i8[i]) & set(s_f32[i])) / k for i in range(16)
    ])
    assert overlap >= 0.95, overlap
    # where the selections agree, the rescored values agree exactly
    for i in range(16):
        common = set(s_i8[i]) & set(s_f32[i])
        m1 = {s: v for s, v in zip(s_i8[i], v_i8[i]) if s in common}
        m2 = {s: v for s, v in zip(s_f32[i], v_f32[i]) if s in common}
        for s in common:
            np.testing.assert_allclose(m1[s], m2[s], rtol=1e-5, atol=1e-6)


def test_ivf_int8_mirror_tracks_incremental_updates(rng, monkeypatch):
    """Overflow appends requantize the int8 mirror so fresh rows are
    findable through the int8 sweep."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # force below IVF_I8_MIN_DIM
    n, dim, k = 2000, 32, 5
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    ivf = IVFIndex.build(vectors, mask, nlist=16, dim=dim)
    assert ivf.vectors_i8c is not None
    new_vec = normalize_batch(
        rng.normal(size=(1, dim)).astype(np.float32)
    )
    ok = ivf.update(
        np.array([n]), new_vec, np.array([True])
    )
    assert ok
    vals, slots = ivf.search(new_vec, k, ef=64, dev=None)
    assert slots[0, 0] == n and vals[0, 0] > 0.99


def test_ivf_i8only_layout_parity(rng, monkeypatch):
    """int8-only postings (no storage-dtype IVF mirror) rescore by slot
    against the engine corpus and match the classic layout's winners."""
    from picovdb_tpu.device import DeviceIndex

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # force below IVF_I8_MIN_DIM
    n, dim, k = 3000, 64, 10
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    queries = normalize_batch(
        vectors[:16] + 0.01 * rng.normal(size=(16, dim)).astype(np.float32)
    )
    dev = DeviceIndex(dim)
    dev.full_upload(vectors, mask)

    ivf8 = IVFIndex.build(vectors, mask, nlist=32, dim=dim, i8_only=True)
    assert ivf8.vectors is None and ivf8.vectors_i8c is not None
    v8, s8 = ivf8.search(queries, k, ef=64, dev=dev)

    ivf = IVFIndex.build(vectors, mask, nlist=32, dim=dim)
    vf, sf = ivf.search(queries, k, ef=64, dev=dev)

    overlap = np.mean([
        len(set(s8[i]) & set(sf[i])) / k for i in range(16)
    ])
    assert overlap >= 0.95, overlap
    # rescored-by-slot scores are exact corpus cosines
    scores = queries @ vectors.T
    for i in range(16):
        np.testing.assert_allclose(
            v8[i], scores[i][s8[i]], rtol=1e-5, atol=1e-6
        )
    # in-place overflow update: the replaced row requantizes against the
    # frozen build-time scales and lands in the overflow region
    assert ivf8.update(np.array([0]), queries[:1], np.array([True]))
    assert ivf8.last_update_clip_fraction <= 0.05
    assert ivf8.overflow_fraction > 0.0
    v_u, s_u = ivf8.search(queries[:1], 1, ef=10**6, dev=dev)
    assert s_u[0, 0] == 0  # found at its (unchanged) corpus slot


def test_ivf_i8only_device_build_path(rng, monkeypatch):
    """i8_only build from a device-resident corpus (the engine path)."""
    from picovdb_tpu.device import DeviceIndex

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    n, dim, k = 2048, 64, 5
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    dev = DeviceIndex(dim)
    dev.full_upload(vectors, mask)
    ivf8 = IVFIndex.build(
        None, mask[: n], dim=dim, nlist=16,
        dev_vectors=dev.vectors, i8_only=True,
    )
    assert ivf8.vectors is None
    queries = normalize_batch(
        vectors[:8] + 0.01 * rng.normal(size=(8, dim)).astype(np.float32)
    )
    vals, slots = ivf8.search(queries, k, ef=64, dev=dev)
    scores = queries @ vectors.T
    oidx = np.argsort(-scores, axis=1)[:, :k]
    recall = np.mean([len(set(slots[i]) & set(oidx[i])) / k for i in range(8)])
    assert recall >= 0.9, recall


def test_engine_i8only_policy_forced(db_path, rng, monkeypatch):
    """PICOVDB_IVF_I8ONLY=1 routes the engine's ANN build to the
    int8-only layout; queries serve through slot rescore."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    monkeypatch.setenv("PICOVDB_IVF_I8ONLY", "1")
    centers = rng.normal(size=(8, 32)).astype(np.float32)
    vecs = (centers[rng.integers(0, 8, 600)]
            + 0.05 * rng.normal(size=(600, 32))).astype(np.float32)
    db = PicoVectorDB(
        embedding_dim=32, storage_file=db_path, index="ivf",
        ivf_nlist=8, ivf_nprobe=8,
    )
    db.upsert([{K_ID: f"x{i}", K_VECTOR: vecs[i]} for i in range(600)])
    res = db.query(vecs[33], top_k=1, ef_search=64)
    assert res[0][K_ID] == "x33"
    assert db._ivf is not None and db._ivf.vectors is None
    assert db._last_topk_strategy == "ivf_i8"
    # a small mutation epoch updates the i8-only layout IN PLACE:
    # appends requantize against the frozen build-time column scales
    new = (centers[0] + 0.05 * rng.normal(size=32)).astype(np.float32)
    db.upsert([{K_ID: "fresh", K_VECTOR: new}])
    db.delete(["x33"])
    res2 = db.query(vecs[33], top_k=1, ef_search=64)
    assert db._last_ann_rebuild_mode == "incremental"
    assert db._ivf.last_update_clip_fraction <= 0.05
    assert res2[0][K_ID] != "x33"
    r_new = db.query(new, top_k=1, ef_search=64)
    assert r_new[0][K_ID] == "fresh"

    # clip guard: a row far outside the build-time dynamic range forces
    # the full-rebuild path instead (fresh scales, recall never traded)
    monkeypatch.setenv("PICOVDB_IVF_I8_CLIP_MAX", "0")
    onehot = np.zeros(32, np.float32)
    onehot[0] = 1.0
    db.upsert([{K_ID: "hot", K_VECTOR: onehot}])
    r_hot = db.query(onehot, top_k=1, ef_search=64)
    assert db._last_ann_rebuild_mode == "full"
    assert r_hot[0][K_ID] == "hot"


def test_ivf_int8_wide_guard_at_high_dim(rng, monkeypatch):
    """dim >= IVF_I8_MIN_DIM defaults the int8 selection band to k+22
    (engine-measured at the 4M ceiling: the k+6 band sheds ~2% of true
    top-10 to selection noise while k+22 recovers recall). This drives
    the k_sel=32 probe shapes and asserts full-probe parity with the
    exact oracle."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # keep the mirror on
    from picovdb_tpu.ops.ivf import _ivf_guard

    assert _ivf_guard(True, 256) == 22
    assert _ivf_guard(True, 64) == 6
    assert _ivf_guard(False, 1024) == 4
    monkeypatch.setenv("PICOVDB_IVF_GUARD", "9")
    assert _ivf_guard(True, 1024) == 9
    monkeypatch.delenv("PICOVDB_IVF_GUARD")

    n, dim, k = 2048, 256, 10
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    queries = normalize_batch(
        vectors[:8] + 0.01 * rng.normal(size=(8, dim)).astype(np.float32)
    )
    ivf = IVFIndex.build(vectors, mask, nlist=16, dim=dim)
    assert ivf.vectors_i8c is not None
    vals, slots = ivf.search(queries, k, ef=1000, dev=None)  # full probe
    scores = queries @ vectors.T
    oidx = np.argsort(-scores, axis=1)[:, :k]
    recall = np.mean([
        len(set(slots[i]) & set(oidx[i].tolist())) / k for i in range(8)
    ])
    assert recall >= 0.99, recall


def test_should_build_is_bytes_aware():
    """auto-tier policy: build once the exact sweep is ~2 GiB of scanned
    bytes (measured crossover on 1024-d clustered data; the probe's fixed
    preamble loses below it), so dim and storage width matter — 1M x 1024
    f32 builds, 1M x 64 does not; the row-count fallback keeps the old
    rule when the caller can't say."""
    from picovdb_tpu.ops.ivf import should_build

    assert should_build(1_000_000, 1024, 4.0)        # 4 GiB f32
    assert not should_build(100_000, 1024, 4.0)      # 0.4 GiB
    assert not should_build(1_000_000, 64, 4.0)      # 0.25 GiB
    assert should_build(2_000_000, 1024, 2.0)        # 4 GiB bf16
    assert not should_build(500_000, 1024, 1.0)      # 0.5 GiB int8
    assert should_build(2_000_000) and not should_build(1_999_999)


def test_ivf_partial_probe_recall_across_incremental_epoch(db_path, rng):
    """The suite's fuzz cells probe at FULL width (nprobe == nlist), which
    can mask probe-routing regressions in the overflow path: this cell
    pins aggregate recall at an explicitly PARTIAL probe width before and
    after an in-place maintenance epoch (mode asserted incremental), each
    against a fresh exact oracle over the live corpus, so appended rows
    entering true top-k sets are not misread as loss."""
    dim, k, m = 32, 5, 24
    vectors, _ = clustered_data(rng, 1200, dim)
    queries, _ = clustered_data(rng, m, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path,
        index="ivf", ivf_nlist=8, ivf_nprobe=3,  # partial: 3 of 8 lists
    )
    db.upsert([{K_ID: f"id{i}", K_VECTOR: vectors[i]} for i in range(1200)])

    def oracle_recall(corpus, ids_all):
        s = normalize_batch(queries.copy()) @ corpus.T
        top = np.argsort(-s, axis=1)[:, :k]
        tot = 0.0
        for i in range(m):
            got = {h[K_ID] for h in db.query(queries[i], top_k=k)}
            tot += len(got & {ids_all[j] for j in top[i]}) / k
        return tot / m

    ids0 = [f"id{i}" for i in range(1200)]
    r_pre = oracle_recall(vectors, ids0)
    assert db._last_ann_rebuild_mode == "full"

    new_rows, _ = clustered_data(rng, 12, dim)  # ~1%: stays incremental
    db.upsert([{K_ID: f"new{j}", K_VECTOR: new_rows[j]} for j in range(12)])
    r_post = oracle_recall(
        np.vstack([vectors, new_rows]), ids0 + [f"new{j}" for j in range(12)]
    )
    assert db._last_ann_rebuild_mode == "incremental"
    # appended rows are served from the always-probed overflow region
    for j in range(12):
        assert db.query(new_rows[j], top_k=1)[0][K_ID] == f"new{j}"
    # partial-probe quality must not degrade across the epoch (small
    # slack: clustered geometry makes probe sets deterministic, but the
    # k-boundary can shift by one tie)
    assert r_post >= r_pre - 1.0 / k, (r_pre, r_post)


@pytest.mark.parametrize("sdt", ["float32", "int8"])
def test_warm_mutation_path_is_identity(db_path, rng, monkeypatch, sdt):
    """PICOVDB_WARM_UPDATES=1 pre-compiles the mutation-path executables
    with identity writes on the live buffers right after the ANN build
    (engine._maybe_warm_mutation_path); query results must be bit-identical
    to an unwarmed twin, both before and after an incremental epoch."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # enable i8 postings at dim 32
    dim = 32
    vectors, _ = clustered_data(rng, 800, dim)
    queries = normalize_batch(
        vectors[:8] + 0.01 * rng.normal(size=(8, dim)).astype(np.float32)
    )
    newv = normalize_batch(
        np.random.default_rng(7).normal(size=(8, dim)).astype(np.float32)
    )
    results = {}
    for warm in ("0", "1"):
        monkeypatch.setenv("PICOVDB_WARM_UPDATES", warm)
        db = PicoVectorDB(
            embedding_dim=dim, storage_file=f"{db_path}_{warm}",
            index="ivf", ivf_nlist=8, storage_dtype=sdt,
        )
        db.upsert(
            [{K_ID: f"id{i}", K_VECTOR: vectors[i]} for i in range(800)]
        )
        db.query(vectors[0], top_k=1)  # triggers build (+ warm when "1")
        assert db._last_ann_rebuild_mode == "full"
        pre = [
            tuple((r[K_ID], round(float(r["_metrics_"]), 5))
                  for r in db.query(q, top_k=5))
            for q in queries
        ]
        db.delete(["id10"])
        db.upsert([{K_ID: f"new{j}", K_VECTOR: newv[j]} for j in range(8)])
        post = [
            tuple((r[K_ID], round(float(r["_metrics_"]), 5))
                  for r in db.query(q, top_k=5))
            for q in queries
        ]
        assert db._last_ann_rebuild_mode == "incremental"
        assert db.query(newv[0], top_k=1)[0][K_ID] == "new0"
        results[warm] = (pre, post)
    assert results["0"] == results["1"]


def test_ivf_classic_mirror_update_is_o_changed(rng, monkeypatch):
    """In-distribution appends clip-scatter the classic int8 mirror
    against FROZEN scales — no whole-mirror requantize (VERDICT r4 weak
    #3); drifted appends trip the clip guard and pay one fresh re-derive.
    Fresh rows stay findable through the int8 sweep either way."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    n, dim, k = 2000, 32, 5
    vectors, _ = clustered_data(rng, n, dim)
    ivf = IVFIndex.build(vectors, np.ones(n, dtype=bool), nlist=16, dim=dim)
    assert ivf.vectors_i8c is not None and ivf._cscale_np is not None
    scales_before = ivf._cscale_np
    new_vec = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    assert ivf.update(np.array([n, n + 1]), new_vec,
                      np.array([True, True]))
    # frozen scales: the guard measured ~0 clip, no re-derive happened
    assert ivf.last_update_clip_fraction is not None
    assert ivf.last_update_clip_fraction <= 0.05
    assert ivf._cscale_np is scales_before
    vals, slots = ivf.search(new_vec[:1], k, ef=64, dev=None)
    assert slots[0, 0] == n and vals[0, 0] > 0.99

    # drifted append (100x the built dynamic range): guard trips, scales
    # re-derive, and the row is STILL served correctly
    big = np.full((1, dim), 100.0, dtype=np.float32)
    assert ivf.update(np.array([n + 2]), big, np.array([True]))
    assert ivf.last_update_clip_fraction > 0.05
    assert ivf._cscale_np is not scales_before
    vals2, slots2 = ivf.search(normalize_batch(big.copy()), k, ef=64,
                               dev=None)
    assert slots2[0, 0] == n + 2


def test_clip_guard_device_born_rebuild_stays_lazy(db_path, rng, monkeypatch):
    """VERDICT r4 #8: on a SINGLE-DEVICE device-born int8 store the
    clip-guard fallback rebuild runs from the resident device corpus —
    the host matrix is never materialized (the mesh tier's host-fed build
    is the remaining exception, tested in test_ivf_mesh)."""
    import jax.numpy as jnp

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    monkeypatch.setenv("PICOVDB_IVF_I8_CLIP_MAX", "0")
    dim, n, k = 32, 3000, 5
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf",
        storage_dtype="int8", ivf_nlist=16,
    )
    db.ingest_device(
        jnp.asarray(vectors), ids=[str(i) for i in range(n)],
        normalize=False,
    )
    db.rebuild_index()
    assert db._host_lazy and db._ivf is not None

    onehot = np.zeros(dim, np.float32)
    onehot[0] = 1.0
    db.upsert([{K_ID: "hot", K_VECTOR: onehot}])
    res = db.query(onehot, top_k=k, ef_search=1000)
    assert db._last_ann_rebuild_mode == "full"
    assert res[0][K_ID] == "hot"
    assert db.query(vectors[7], top_k=1)[0][K_ID] == "7"
    # the fallback must NOT have materialized the host corpus
    assert db._host_lazy


def test_grow_oom_fallback_frees_ivf_and_warm_rebuilds(db_path, rng,
                                                       monkeypatch):
    """When the device grow OOMs with the IVF postings resident (HBM
    ceiling), the engine frees the postings (stashing warm centroids),
    retries the grow, and warm-rebuilds the ANN tier from the grown
    device corpus — never materializing the host matrix."""
    import jax.numpy as jnp

    from picovdb_tpu.constants import ROW_PAD

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    dim, n = 32, ROW_PAD - 50
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf",
        storage_dtype="int8", ivf_nlist=16,
    )
    db.ingest_device(jnp.asarray(vectors), ids=[str(i) for i in range(n)],
                     normalize=False)
    db.rebuild_index()
    assert db._host_lazy and db._ivf is not None

    real_grow = db._dev.grow
    calls = {"n": 0}

    def flaky_grow(size):
        calls["n"] += 1
        if calls["n"] == 1:
            return False  # simulated RESOURCE_EXHAUSTED
        return real_grow(size)

    monkeypatch.setattr(db._dev, "grow", flaky_grow)
    extra = rng.normal(size=(100, dim)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    db.upsert([{K_ID: f"x{i}", K_VECTOR: extra[i]} for i in range(100)])
    res = db.query(extra[4], top_k=1, ef_search=1000)
    assert calls["n"] == 2  # failed once, retried after freeing the IVF
    assert res[0][K_ID] == "x4"
    assert db._last_ann_rebuild_mode == "full"
    assert db._ivf is not None  # rebuilt
    assert db._ivf_warm_blob is None  # warm stash consumed
    assert db._host_lazy  # never materialized
    assert db._dev.cap > ROW_PAD
    assert db.query(vectors[7], top_k=1, ef_search=1000)[0][K_ID] == "7"
