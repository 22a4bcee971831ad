"""Sharded IVF tier on the virtual 8-device CPU mesh.

Round-3 capability (VERDICT.md round-2 item 2): a mesh store with
`index="ivf"` must serve probed results with oracle parity at full nprobe,
replacing the round-2 warn-and-fall-back-to-exact behavior. The reference
role being replaced at multi-chip scale: FAISS HNSW
(picovdb/pico_vdb.py:171-212).
"""

import jax
import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR
from picovdb_tpu.parallel import make_mesh
from picovdb_tpu.parallel.ivf_mesh import ShardedIVF
from picovdb_tpu.utils import normalize_batch
from test_ivf import clustered_data

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs multiple (virtual) devices"
)


def test_sharded_ivf_full_probe_is_exact(rng):
    """nprobe = nlist probes every cluster on every shard -> oracle parity."""
    mesh = make_mesh()
    n, dim, k = 4000, 32, 10
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    ivf = ShardedIVF.build(vectors, mask, mesh, nlist=16, dim=dim)
    assert ivf.slots.shape[0] == mesh.shape["shard"] * ivf.cap_shard

    queries = normalize_batch(
        vectors[:16] + 0.01 * rng.normal(size=(16, dim)).astype(np.float32)
    )
    vals, slots = ivf.search(queries, k, ef=1000, dev=None)  # all lists
    scores = queries @ vectors.T
    oidx = np.argsort(-scores, axis=1)[:, :k]
    ovals = np.take_along_axis(scores, oidx, axis=1)
    np.testing.assert_allclose(vals, ovals, rtol=1e-5, atol=1e-6)
    for qi in range(16):
        np.testing.assert_allclose(
            scores[qi][slots[qi]], ovals[qi], rtol=1e-5, atol=1e-6
        )


def test_sharded_ivf_nprobe_tradeoff_and_mask(rng):
    mesh = make_mesh()
    n, dim, k = 4000, 32, 5
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    mask[100:200] = False  # deleted rows must never surface
    ivf = ShardedIVF.build(vectors, mask, mesh, nlist=32, dim=dim)
    queries = normalize_batch(
        vectors[:8] + 0.01 * rng.normal(size=(8, dim)).astype(np.float32)
    )
    scores = np.where(mask[None, :], queries @ vectors.T, -np.inf)
    oidx = np.argsort(-scores, axis=1)[:, :k]
    recalls = {}
    for ef in (2, 128):
        vals, slots = ivf.search(queries, k, ef=ef, dev=None)
        assert not (set(range(100, 200)) & set(slots.ravel().tolist()))
        recalls[ef] = np.mean(
            [len(set(slots[i]) & set(oidx[i])) / k for i in range(8)]
        )
    assert recalls[128] >= recalls[2]
    assert recalls[128] >= 0.9, recalls


def test_engine_mesh_ivf_end_to_end(db_path, rng):
    """index='ivf' on a mesh store serves through the sharded probe scan."""
    mesh = make_mesh()
    dim, n, k = 24, 3000, 8
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        ivf_nlist=32,
    )
    db.upsert(
        [{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)]
    )
    res = db.query(vectors[77], top_k=k, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "77"
    # sharded-exact agreement at full probe width
    db_exact = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path + "_exact", mesh=mesh,
        index="exact",
    )
    db_exact.upsert(
        [{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)]
    )
    r2 = db_exact.query(vectors[77], top_k=k)
    assert [r[K_ID] for r in res] == [r[K_ID] for r in r2]

    # a small delete epoch routes through the INCREMENTAL maintenance
    # path (per-shard overflow regions, VERDICT r3 item 2) and disappears
    db.delete(["77"])
    res3 = db.query(vectors[77], top_k=k, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf")
    assert db._last_ann_rebuild_mode == "incremental"
    assert all(r[K_ID] != "77" for r in res3)


def test_engine_mesh_ivf_sidecar_roundtrip(db_path, rng):
    """Mesh IVF persists the shared sidecar schema and reloads warm."""
    mesh = make_mesh()
    dim, n, k = 24, 2500, 5
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        ivf_nlist=16,
    )
    db.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)])
    db.save()

    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        ivf_nlist=16,
    )
    assert db2._ivf is not None  # sidecar reused, no cold retrain
    res = db2.query(vectors[42], top_k=k, ef_search=1000)
    assert db2._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "42"

    # the same sidecar loads into a single-device process (shared schema)
    db3 = PicoVectorDB(embedding_dim=dim, storage_file=db_path, index="ivf")
    assert db3._ivf is not None
    r3 = db3.query(vectors[42], top_k=k, ef_search=1000)
    assert r3[0][K_ID] == "42"


def test_engine_mesh_int8_only_ivf(db_path, rng, monkeypatch):
    """index='ivf' on a mesh store with int8 STORAGE: the int8-only
    per-shard postings layout (no full-precision postings copy — rows are
    partitioned by their owning corpus shard and the exact rescore gathers
    the engine's sharded int8 corpus by local slot, dequantized)."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # force below IVF_I8_MIN_DIM
    mesh = make_mesh()
    dim, n, k = 32, 4096, 8
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        storage_dtype="int8", ivf_nlist=16,
    )
    db.upsert_columnar(vectors.copy(), ids=[str(i) for i in range(n)])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None  # i8-only
    assert db._ivf.corpus_cap == db._dev.cap
    res = db.query(vectors[77], top_k=k, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "77"
    # full-probe agreement with the sharded-exact scan on the same store
    # (both rank dequantized int8 storage scores)
    exact = db.query(vectors[77], top_k=k, ef_search=1000, where=lambda d: True)
    assert {r[K_ID] for r in res} == {r[K_ID] for r in exact}

    # a small mutation epoch routes through the INCREMENTAL path:
    # appended rows requantize against the frozen build-time per-shard
    # scales and land on their owning corpus shard
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    db.upsert([{K_ID: f"n{j}", K_VECTOR: new[j]} for j in range(2)])
    db.delete(["77"])
    res3 = db.query(vectors[77], top_k=k, ef_search=1000)
    assert db._last_ann_rebuild_mode == "incremental"
    # in-distribution appends clip ~nothing against the frozen scales
    assert db._ivf.last_update_clip_fraction <= 0.02
    assert all(r[K_ID] != "77" for r in res3)
    r_new = db.query(new[0], top_k=k, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf")
    assert r_new[0][K_ID] == "n0"

    # sidecar roundtrip rebuilds the i8-only layout warm
    db.save()
    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        storage_dtype="int8", ivf_nlist=16,
    )
    assert db2._ivf is not None and db2._ivf.vectors is None
    r2 = db2.query(vectors[42], top_k=k, ef_search=1000)
    assert r2[0][K_ID] == "42"


def test_sharded_ivf_int8_parity(rng, monkeypatch):
    """Per-shard int8 postings select the same winners as the f32 sweep
    through the cross-device merge."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # force below IVF_I8_MIN_DIM
    mesh = make_mesh()
    n, dim, k = 4096, 32, 8
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    queries = normalize_batch(
        vectors[:16] + 0.01 * rng.normal(size=(16, dim)).astype(np.float32))

    ivf = ShardedIVF.build(vectors, mask, mesh, nlist=16, dim=dim)
    assert ivf.vectors_i8c is not None
    v_i8, s_i8 = ivf.search(queries, k, ef=64, dev=None)

    ivf.vectors_i8c = None
    ivf.cscale = None
    v_f32, s_f32 = ivf.search(queries, k, ef=64, dev=None)

    overlap = np.mean([
        len(set(s_i8[i]) & set(s_f32[i])) / k for i in range(16)
    ])
    assert overlap >= 0.95, overlap


def test_engine_mesh_capacity_triggered_i8_only(db_path, rng, monkeypatch):
    """A bf16-storage mesh store whose classic per-shard IVF mirror would
    overflow the per-device memory budget auto-selects the int8-only
    postings layout — the mesh analog of the single-device
    capacity-ceiling rule (engine._ivf_i8_only, now per-shard)."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # enable below IVF_I8_MIN_DIM
    # a deliberately tiny per-device budget stands in for "corpus near
    # the per-shard memory limit" at test scale
    monkeypatch.setenv("PICOVDB_DEVICE_MEMORY_MB", "0.01")
    mesh = make_mesh()
    dim, n, k = 32, 4096, 8
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        storage_dtype="bfloat16", ivf_nlist=16,
    )
    db.upsert_columnar(vectors.copy(), ids=[str(i) for i in range(n)])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None  # i8-only layout
    assert db._ivf.corpus_cap == db._dev.cap
    res = db.query(vectors[77], top_k=k, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "77"
    # full-probe agreement with the sharded-exact scan on the same store
    exact = db.query(
        vectors[77], top_k=k, ef_search=1000, where=lambda d: True
    )
    assert {r[K_ID] for r in res} == {r[K_ID] for r in exact}

    # sidecar roundtrip rebuilds the i8-only layout warm
    db.save()
    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        storage_dtype="bfloat16", ivf_nlist=16,
    )
    assert db2._ivf is not None and db2._ivf.vectors is None
    r2 = db2.query(vectors[42], top_k=k, ef_search=1000)
    assert r2[0][K_ID] == "42"

    # with an ample budget the same store keeps the classic layout
    monkeypatch.setenv("PICOVDB_DEVICE_MEMORY_MB", str(13 * 1024))
    db3 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        storage_dtype="bfloat16", ivf_nlist=16,
    )
    assert db3._ivf is not None and db3._ivf.vectors is not None


# ---------------------------------------------------------------------------
# incremental maintenance (VERDICT r3 item 2): per-shard overflow regions
# ---------------------------------------------------------------------------

def test_sharded_ivf_update_in_place(rng):
    """update() applies deletes/updates/inserts as O(changed) scatters and
    the full-probe search matches the post-mutation oracle exactly."""
    mesh = make_mesh()
    n, dim, k = 4000, 32, 10
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    ivf = ShardedIVF.build(vectors, mask, mesh, nlist=16, dim=dim)
    assert ivf._n_used is not None
    assert ivf.overflow_fraction == 0.0

    # mutation set: delete 2 rows, update 3 in place, append 4 new
    corpus = np.vstack([vectors, np.zeros((4, dim), np.float32)])
    live = np.ones(n + 4, dtype=bool)
    upd = normalize_batch(rng.normal(size=(7, dim)).astype(np.float32))
    changed = np.array([5, 6, 100, 200, 300, n, n + 1, n + 2, n + 3])
    flags = np.array([False, False, True, True, True, True, True, True,
                      True])
    rows = np.zeros((9, dim), np.float32)
    rows[2:] = upd
    corpus[changed[2:]] = upd
    live[5] = live[6] = False
    ok = ivf.update(changed, rows, flags)
    assert ok
    assert 0.0 < ivf.overflow_fraction < 0.01

    queries = normalize_batch(
        rng.normal(size=(12, dim)).astype(np.float32)
    )
    vals, slots = ivf.search(queries, k, ef=1000, dev=None)  # all lists
    scores = np.where(live[None, :], queries @ corpus.T, -np.inf)
    oidx = np.argsort(-scores, axis=1)[:, :k]
    ovals = np.take_along_axis(scores, oidx, axis=1)
    np.testing.assert_allclose(vals, ovals, rtol=1e-5, atol=1e-6)
    for qi in range(12):
        np.testing.assert_allclose(
            scores[qi][slots[qi]], ovals[qi], rtol=1e-5, atol=1e-6
        )

    # updated vectors are findable at their new positions
    v2, s2 = ivf.search(upd[3:4], 1, ef=1000, dev=None)
    assert s2[0, 0] == changed[5]


def test_sharded_ivf_update_with_i8_mirror(rng, monkeypatch):
    """The per-shard int8 postings mirror re-derives after an update (stale
    column scales would skew selection)."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    mesh = make_mesh()
    n, dim, k = 3000, 32, 5
    vectors, _ = clustered_data(rng, n, dim)
    ivf = ShardedIVF.build(
        vectors, np.ones(n, dtype=bool), mesh, nlist=16, dim=dim
    )
    assert ivf.vectors_i8c is not None
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    ok = ivf.update(
        np.array([n, n + 1]), new, np.array([True, True])
    )
    assert ok
    v, s = ivf.search(new[:1], 1, ef=1000, dev=None)
    assert s[0, 0] == n


def test_sharded_ivf_update_overflow_exhaustion(rng):
    """An append set larger than the total per-shard slack returns False
    (caller rebuilds) without mutating anything."""
    mesh = make_mesh()
    n, dim = 2000, 16
    vectors, _ = clustered_data(rng, n, dim)
    ivf = ShardedIVF.build(
        vectors, np.ones(n, dtype=bool), mesh, nlist=8, dim=dim
    )
    total_free = int(
        mesh.shape["shard"] * ivf.cap_shard - ivf._n_used.sum()
    )
    m = total_free + 1
    big = normalize_batch(rng.normal(size=(m, dim)).astype(np.float32))
    before = int(ivf._n_used.sum())
    ok = ivf.update(
        np.arange(n, n + m), big, np.ones(m, dtype=bool)
    )
    assert not ok
    assert int(ivf._n_used.sum()) == before


def test_engine_mesh_ivf_incremental_epoch(db_path, rng):
    """A small mutation epoch on a mesh IVF store re-serves at oracle
    parity through the incremental path — no host re-materialization, no
    k-means (VERDICT r3 item 2 'done' criteria, scaled to test size)."""
    mesh = make_mesh()
    dim, n, k = 24, 3000, 8
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        ivf_nlist=32,
    )
    db.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)])
    db.query(vectors[0], top_k=k)  # build epoch
    assert db._last_ann_rebuild_mode == "full"

    # mutation epoch: 3 new rows, 2 updates, 1 delete
    new = normalize_batch(rng.normal(size=(5, dim)).astype(np.float32))
    db.upsert(
        [{K_ID: f"new{j}", K_VECTOR: new[j]} for j in range(3)]
        + [{K_ID: "10", K_VECTOR: new[3]}, {K_ID: "11", K_VECTOR: new[4]}]
    )
    db.delete(["20"])
    res = db.query(new[0], top_k=k, ef_search=1000)
    assert db._last_ann_rebuild_mode == "incremental"
    assert db._last_sync_mode == "incremental"
    assert db._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "new0"
    r_upd = db.query(new[3], top_k=k, ef_search=1000)
    assert r_upd[0][K_ID] == "10"
    gone = db.query(vectors[20], top_k=k, ef_search=1000)
    assert all(r[K_ID] != "20" for r in gone)

    # full-probe parity with the exact scan over the mutated store
    ids_col, _ = db.query_columnar(
        normalize_batch(rng.normal(size=(16, dim)).astype(np.float32)),
        top_k=k, ef_search=1000,
    )
    # exact twin store
    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path + "_x", mesh=mesh,
        index="exact",
    )
    db2.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)])
    db2.upsert(
        [{K_ID: f"new{j}", K_VECTOR: new[j]} for j in range(3)]
        + [{K_ID: "10", K_VECTOR: new[3]}, {K_ID: "11", K_VECTOR: new[4]}]
    )
    db2.delete(["20"])
    qs = normalize_batch(rng.normal(size=(16, dim)).astype(np.float32))
    i1, _ = db.query_columnar(qs, top_k=k, ef_search=1000)
    i2, _ = db2.query_columnar(qs, top_k=k)
    np.testing.assert_array_equal(i1, i2)


def test_engine_mesh_ivf_sidecar_after_incremental(db_path, rng):
    """save() after incremental epochs persists a refreshed sidecar that
    reloads warm (assign_rows matches the live active set)."""
    mesh = make_mesh()
    dim, n, k = 24, 2500, 5
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        ivf_nlist=16,
    )
    db.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)])
    db.query(vectors[0], top_k=k)
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    db.upsert([{K_ID: f"n{j}", K_VECTOR: new[j]} for j in range(2)])
    db.delete(["7"])
    db.query(new[0], top_k=k)
    assert db._last_ann_rebuild_mode == "incremental"
    db.save()

    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        ivf_nlist=16,
    )
    assert db2._ivf is not None  # refreshed sidecar reused, no retrain
    res = db2.query(new[1], top_k=k, ef_search=1000)
    assert res[0][K_ID] == "n1"
    assert all(r[K_ID] != "7" for r in db2.query(
        vectors[7], top_k=k, ef_search=1000
    ))


def test_sharded_ivf_i8only_update_owner_placement(rng, monkeypatch):
    """int8-only in-place updates: appended rows requantize against the
    FROZEN build-time per-shard scales and land on their OWNING corpus
    shard (rescore-locality); out-of-range appends trip the clip guard
    and refuse without mutating any bookkeeping."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    mesh = make_mesh()
    nshards = mesh.shape["shard"]
    n, dim = 4096, 32
    cap = n  # corpus capacity == n, multiple of nshards
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    mask[n - 16:] = False  # leave free corpus slots for the appends
    ivf = ShardedIVF.build(
        vectors, mask, mesh, nlist=16, dim=dim, i8_only=True,
        corpus_cap=cap,
    )
    assert ivf.vectors is None and ivf._n_used is not None
    assert ivf.overflow_fraction == 0.0
    shard_rows = cap // nshards

    # append two rows into known corpus slots -> owner shards are fixed
    slots = np.array([n - 16, n - 1], dtype=np.int64)
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    used_before = ivf._n_used.copy()
    ok = ivf.update(slots, new, np.array([True, True]))
    assert ok
    assert ivf.last_update_clip_fraction <= 0.02
    for j, slot in enumerate(slots):
        owner = slot // shard_rows
        row = int(ivf._slot2row[slot])
        assert row // ivf.cap_shard == owner  # owner-shard placement
        # stored local id resolves back to the global slot
        local = int(np.asarray(ivf.slots)[row])
        assert owner * shard_rows + local == slot
    assert int(ivf._n_used.sum()) == int(used_before.sum()) + 2

    # delete-only epoch stays in place too
    ok2 = ivf.update(np.array([5]), np.zeros((1, dim), np.float32),
                     np.array([False]))
    assert ok2
    assert not bool(np.asarray(ivf.active)[int(ivf._slot2row[5])] if
                    ivf._slot2row[5] >= 0 else False)

    # clip guard: a row far outside the build-time dynamic range refuses
    wild = np.zeros((1, dim), np.float32)
    wild[0, :8] = 1.0  # 8/32 components at 0.35 >> clustered col maxima
    state = (ivf._n_used.copy(), int(ivf._slot2row[n - 8]))
    ok3 = ivf.update(np.array([n - 8]), wild, np.array([True]))
    assert not ok3
    assert ivf.last_update_clip_fraction > 0.0
    assert np.array_equal(ivf._n_used, state[0])  # nothing mutated
    assert int(ivf._slot2row[n - 8]) == state[1]


def test_engine_mesh_i8only_clip_guard_falls_back_to_rebuild(
    db_path, rng, monkeypatch
):
    """When an append clips too hard against the frozen scales the engine
    falls back to a full rebuild (fresh scales) — recall is never traded
    for the in-place fast path."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    monkeypatch.setenv("PICOVDB_IVF_I8_CLIP_MAX", "0")
    mesh = make_mesh()
    dim, n, k = 32, 4096, 8
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        storage_dtype="int8", ivf_nlist=16,
    )
    db.upsert_columnar(vectors.copy(), ids=[str(i) for i in range(n)])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None

    onehot = np.zeros(dim, np.float32)
    onehot[0] = 1.0  # normalizes to e0: clips against clustered scales
    db.upsert([{K_ID: "hot", K_VECTOR: onehot}])
    res = db.query(onehot, top_k=k, ef_search=1000)
    assert db._last_ann_rebuild_mode == "full"  # guard refused in-place
    assert res[0][K_ID] == "hot"


@pytest.mark.parametrize("i8_only", [False, True])
def test_sharded_ivf_warm_update_identity(rng, monkeypatch, i8_only):
    """warm_update_path() pre-compiles the mesh mutation executables with
    identity writes: full-probe results must be unchanged by the warm, and
    a real update() afterwards behaves exactly as without it."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    mesh = make_mesh()
    n, dim, k = 3000, 32, 10
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    ivf = ShardedIVF.build(
        vectors, mask, mesh, nlist=16, dim=dim, i8_only=i8_only,
        corpus_cap=n + 1024 if i8_only else None,  # engine cap > size
    )
    store0 = np.asarray(ivf.vectors_i8c if i8_only else ivf.vectors)
    slots0 = np.asarray(ivf.slots)
    act0 = np.asarray(ivf.active)
    c2t0 = np.asarray(ivf.cluster2tile)
    ivf.warm_update_path()
    np.testing.assert_array_equal(
        np.asarray(ivf.vectors_i8c if i8_only else ivf.vectors), store0
    )
    np.testing.assert_array_equal(np.asarray(ivf.slots), slots0)
    np.testing.assert_array_equal(np.asarray(ivf.active), act0)
    np.testing.assert_array_equal(np.asarray(ivf.cluster2tile), c2t0)
    # a real epoch after the warm: appended rows land and are served
    new = normalize_batch(rng.normal(size=(3, dim)).astype(np.float32))
    ok = ivf.update(
        np.array([n, n + 1, n + 2]), new, np.array([True, True, True])
    )
    assert ok
    if not i8_only:  # i8-only search needs an engine dev for the rescore
        queries = normalize_batch(
            rng.normal(size=(8, dim)).astype(np.float32)
        )
        v2, s2 = ivf.search(new, 1, ef=1000, dev=None)
        np.testing.assert_array_equal(s2[:, 0], [n, n + 1, n + 2])
    else:
        assert all(
            int(ivf._slot2row[s]) >= 0 for s in (n, n + 1, n + 2)
        )


def test_sharded_classic_mirror_update_is_o_changed(rng, monkeypatch):
    """Mesh classic layout: in-distribution appends clip-scatter the
    per-shard int8 mirror against frozen scales (no re-derive); drifted
    appends trip the guard and re-derive with fresh scales."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    mesh = make_mesh()
    n, dim = 3000, 32
    vectors, _ = clustered_data(rng, n, dim)
    ivf = ShardedIVF.build(
        vectors, np.ones(n, dtype=bool), mesh, nlist=16, dim=dim
    )
    assert ivf.vectors_i8c is not None and ivf._cscale_np is not None
    frozen = ivf._cscale_np
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    assert ivf.update(np.array([n, n + 1]), new, np.array([True, True]))
    assert ivf.last_update_clip_fraction <= 0.05
    assert ivf._cscale_np is frozen
    v, s = ivf.search(new[:1], 1, ef=1000, dev=None)
    assert s[0, 0] == n

    big = np.full((1, dim), 100.0, dtype=np.float32)
    assert ivf.update(np.array([n + 2]), big, np.array([True]))
    assert ivf.last_update_clip_fraction > 0.05
    assert ivf._cscale_np is not frozen
    v2, s2 = ivf.search(normalize_batch(big.copy()), 1, ef=1000, dev=None)
    assert s2[0, 0] == n + 2


def test_engine_mesh_i8only_clip_guard_device_born(db_path, rng, monkeypatch):
    """VERDICT r4 #8 worst case: drifted appends on a DEVICE-BORN (lazy)
    int8-only mesh store — the guard refuses the in-place path and the
    full rebuild (which is host-fed on the mesh tier) must still serve
    correct results."""
    import jax.numpy as jnp

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    monkeypatch.setenv("PICOVDB_IVF_I8_CLIP_MAX", "0")
    mesh = make_mesh()
    dim, n, k = 32, 4096, 8
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        storage_dtype="int8", ivf_nlist=16,
    )
    db.ingest_device(
        jnp.asarray(vectors), ids=[str(i) for i in range(n)],
        normalize=False,
    )
    assert db._host_lazy
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None

    onehot = np.zeros(dim, np.float32)
    onehot[0] = 1.0
    db.upsert([{K_ID: "hot", K_VECTOR: onehot}])
    res = db.query(onehot, top_k=k, ef_search=1000)
    assert db._last_ann_rebuild_mode == "full"  # guard refused in-place
    assert res[0][K_ID] == "hot"
    # pre-drift rows still served
    assert db.query(vectors[7], top_k=1)[0][K_ID] == "7"


def test_engine_mesh_i8only_empty_shard_append_self_heals(
    db_path, rng, monkeypatch
):
    """r5 review: owner shards with ZERO built rows kept the default
    column scale. With 1.0 defaults, an append routed to such a shard
    quantized a unit-norm row to ~all-zero codes WITHOUT clipping — the
    clip guard never tripped, update() claimed success, and the row was
    invisible to selection until the next full rebuild. The default is
    now the quantizer's floor scale, so the append clips ~100%, the
    guard refuses, and the fallback rebuild derives real scales."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    mesh = make_mesh()
    nshards = mesh.shape["shard"]
    dim, k = 32, 4
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        storage_dtype="int8", ivf_nlist=8,
    )
    seed, _ = clustered_data(rng, 64, dim)
    db.upsert([{K_ID: f"s{i}", K_VECTOR: seed[i]} for i in range(64)])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None  # i8-only
    shard_rows = int(db._dev.cap) // nshards

    # fill the whole of corpus shard 0 so the NEXT free slot lands on
    # shard 1, which has zero built rows
    if shard_rows > 64:
        more, _ = clustered_data(rng, shard_rows - 64, dim)
        db.upsert([
            {K_ID: f"m{i}", K_VECTOR: more[i]}
            for i in range(shard_rows - 64)
        ])
    db.rebuild_index()  # shard 0 full, shards 1+ built empty

    newv = rng.normal(size=dim).astype(np.float32)
    newv /= np.linalg.norm(newv)
    db.upsert([{K_ID: "fresh", K_VECTOR: newv}])  # slot == shard_rows
    res = db.query(newv, top_k=k, ef_search=10**6)
    assert res[0][K_ID] == "fresh"  # pre-fix: invisible to selection
    # guard must have refused the in-place path on the floor-scale shard
    assert db._last_ann_rebuild_mode == "full"
