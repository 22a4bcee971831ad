"""ANN routing in the pipelined serving lanes (query_batched /
query_columnar).

Previously only the single-dispatch `query` lane consulted the IVF tier;
the batch lanes always swept exact — so an `index="ivf"` store served its
probe scan for `query` but not for the serving APIs. Now every chunk goes
through the same routing rule as `_dispatch_query` (explicit "ivf" always
probes, like the reference always uses a present FAISS index,
picovdb/pico_vdb.py:667-668; "auto" applies the probed-union bound per
chunk), with the all-empty-probe self-heal re-serving exact from the
dispatch-time snapshot.
"""

import jax
import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID
from test_ivf import clustered_data


@pytest.fixture
def ivf_db(db_path, rng):
    n, dim = 3000, 32
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, index="ivf", ivf_nlist=16
    )
    db.upsert_columnar(vectors.copy(), ids=[str(i) for i in range(n)])
    return db, vectors


def test_query_batched_routes_through_ivf(ivf_db, rng):
    db, vectors = ivf_db
    q = vectors[:12] + 0.01 * rng.normal(size=(12, 32)).astype(np.float32)
    res = db.query_batched(q, top_k=5, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf"), db._last_topk_strategy
    assert len(res) == 12
    for i in range(12):
        assert res[i][0][K_ID] == str(i)
    # full-probe agreement with the exact single-dispatch path
    exact = [
        db.query(q[i], top_k=5, where=lambda d: True) for i in range(12)
    ]
    for r_b, r_e in zip(res, exact):
        assert [h[K_ID] for h in r_b] == [h[K_ID] for h in r_e]


def test_query_columnar_routes_through_ivf(ivf_db, rng):
    db, vectors = ivf_db
    q = vectors[:8] + 0.01 * rng.normal(size=(8, 32)).astype(np.float32)
    ids_col, scores = db.query_columnar(q, top_k=5)
    assert db._last_topk_strategy.startswith("ivf"), db._last_topk_strategy
    for i in range(8):
        assert ids_col[i][0] == str(i)
        assert np.all(np.diff(scores[i][np.isfinite(scores[i])]) <= 1e-6)


def test_filtered_batches_stay_exact(ivf_db, rng):
    db, vectors = ivf_db
    q = vectors[:4]
    res = db.query_batched(q, top_k=5, where={K_ID: {"$in": ["1", "2"]}})
    assert not db._last_topk_strategy.startswith("ivf")
    assert all(h[K_ID] in ("1", "2") for r in res for h in r)


def test_auto_index_large_chunks_stay_exact(ivf_db, rng):
    """index='auto': a large chunk's probed union covers the lists, so the
    union bound routes the serving lanes to the exact sweep, while tiny
    chunks still probe (the same per-chunk rule as _dispatch_query)."""
    db, vectors = ivf_db
    db.rebuild_index()  # build the tier while index='ivf' (auto wouldn't
    # keep one at 3k rows), then flip the routing kind with no pending
    # mutations so the tier survives
    db._index_kind = "auto"
    assert db._ivf is not None
    q = np.asarray(vectors[:256], dtype=np.float32)
    db.query_batched(q, top_k=5, batch_size=256, ef_search=1000)
    assert not db._last_topk_strategy.startswith("ivf"), (
        db._last_topk_strategy
    )
    # ef=4 -> nprobe=2 of 16 lists: union 1/8 at Q=1, well under the bound
    db.query_batched(q[:1], top_k=5, ef_search=4)
    assert db._last_topk_strategy.startswith("ivf"), db._last_topk_strategy


def test_mesh_store_batched_lane_probes(db_path, rng):
    """The sharded IVF tier serves the batch lanes on a mesh store too."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    from picovdb_tpu.parallel import make_mesh

    mesh = make_mesh()
    n, dim = 3000, 24
    vectors, _ = clustered_data(rng, n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, mesh=mesh, index="ivf",
        ivf_nlist=16,
    )
    db.upsert_columnar(vectors.copy(), ids=[str(i) for i in range(n)])
    q = vectors[:6] + 0.01 * rng.normal(size=(6, dim)).astype(np.float32)
    res = db.query_batched(q, top_k=5, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf"), db._last_topk_strategy
    for i in range(6):
        assert res[i][0][K_ID] == str(i)
    ids_col, _ = db.query_columnar(q, top_k=5)
    assert db._last_topk_strategy.startswith("ivf")
    for i in range(6):
        assert ids_col[i][0] == str(i)


def test_lane_normalizes_queries_for_the_tier(ivf_db, rng):
    """The IVF tiers expect pre-normalized queries (query() normalizes
    before _dispatch_query; the exact lanes normalize fused on device).
    A scaled query through the batch lanes must return the SAME scores as
    the single-dispatch path — ranking is scale-invariant but scores and
    better_than floors are not."""
    db, vectors = ivf_db
    q = 5.0 * (vectors[:3] + 0.01 * rng.normal(size=(3, 32)).astype(
        np.float32))
    res_lane = db.query_batched(q, top_k=5, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf")
    for i in range(3):
        ref = db.query(q[i], top_k=5, ef_search=1000)
        assert [h[K_ID] for h in res_lane[i]] == [h[K_ID] for h in ref]
        for a, b in zip(res_lane[i], ref):
            assert abs(a["_metrics_"] - b["_metrics_"]) < 1e-5
    # better_than floors apply to normalized scores
    floor = res_lane[0][2]["_metrics_"]
    res_bt = db.query_batched(q[:1], top_k=5, better_than=floor - 1e-6,
                              ef_search=1000)
    assert all(h["_metrics_"] >= floor - 1e-6 for h in res_bt[0])
    assert len(res_bt[0]) >= 3


def test_empty_batch_through_the_lanes(ivf_db):
    """A (0, dim) batch returns empty results on both lanes (regression:
    the per-chunk IVF bookkeeping indexed chunk_ivf[-1] on no chunks)."""
    db, _ = ivf_db
    q = np.empty((0, 32), dtype=np.float32)
    assert db.query_batched(q, top_k=5) == []
    ids_col, scores = db.query_columnar(q, top_k=5)
    assert ids_col.shape == (0, 5) and scores.shape == (0, 5)


def test_debug_reports_ann_operating_point(ivf_db):
    """last_query_debug exposes the live ANN operating point (nlist,
    default nprobe, layout, postings dtype) so operators can see what
    the tier would serve with."""
    db, vectors = ivf_db
    db.rebuild_index()
    op = db.last_query_debug()["ann_operating_point"]
    assert op is not None
    assert op["nlist"] == 16
    assert op["layout"] == "classic"
    assert 1 <= op["nprobe_default"] <= 16
    assert op["postings"] in ("float32", "int8")

    db2 = PicoVectorDB(
        embedding_dim=32, storage_file=db._path + "_exact", index="exact"
    )
    assert db2.last_query_debug()["ann_operating_point"] is None
