"""Differential tests: device paths vs a NumPy oracle.

The device analog of the reference's FAISS-vs-NumPy parity test
(tests/test_task14_faiss_vs_numpy_results.py) and argsort-vs-argpartition
equivalence test (test_task20): every device top-k path must match an exact
NumPy argsort oracle on deterministic data.
"""

import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID, K_METRICS
from picovdb_tpu.ops.exact import make_exact_topk
from picovdb_tpu.utils import normalize_batch
from conftest import make_items


def numpy_oracle_topk(queries, vectors, mask, k):
    scores = queries @ vectors.T
    scores = np.where(mask[None, :], scores, -np.inf)
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(scores, order, axis=1)
    return vals, order


@pytest.mark.parametrize("n,dim,k", [(64, 16, 5), (300, 32, 17), (1000, 64, 64)])
def test_exact_topk_matches_oracle(rng, n, dim, k):
    vectors = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    queries = normalize_batch(rng.normal(size=(8, dim)).astype(np.float32))
    mask = rng.random(n) > 0.3

    fn = make_exact_topk(k)
    vals, idxs = fn(queries, vectors, mask)
    vals, idxs = np.asarray(vals), np.asarray(idxs)
    ovals, oidxs = numpy_oracle_topk(queries, vectors, mask, k)

    np.testing.assert_allclose(vals, ovals, rtol=1e-5, atol=1e-6)
    # indices must agree wherever scores are distinct enough to order strictly
    for qi in range(queries.shape[0]):
        strict = np.diff(ovals[qi]) < -1e-6
        same = idxs[qi] == oidxs[qi]
        assert same[:1].all()
        assert (same[1:] | ~strict).all()


def test_engine_results_match_bruteforce(db_path, rng):
    dim, n = 24, 200
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path)
    items, vecs = make_items(rng, n, dim)
    db.upsert(items)
    db.delete([f"id{i}" for i in range(0, n, 7)])

    qs = rng.normal(size=(5, dim)).astype(np.float32)
    res = db.query(qs, top_k=10)

    # brute-force oracle over active host rows
    host = np.asarray(db._host_vectors)
    mask = db._active_mask
    qn = normalize_batch(qs)
    ovals, oidxs = numpy_oracle_topk(qn, host, mask, 10)
    for qi in range(5):
        got_ids = [r[K_ID] for r in res[qi]]
        want_ids = [db._ids[j] for j in oidxs[qi]]
        got_scores = np.array([r[K_METRICS] for r in res[qi]])
        np.testing.assert_allclose(got_scores, ovals[qi][: len(got_scores)],
                                   rtol=1e-4, atol=1e-5)
        # order may swap only between near-equal scores
        assert got_ids[0] == want_ids[0]
        assert set(got_ids) == set(want_ids[: len(got_ids)])


def test_filtered_query_matches_restricted_bruteforce(db_path, rng):
    dim, n = 16, 120
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path)
    items, vecs = make_items(rng, n, dim, extra=lambda i: {"tag": i % 4})
    db.upsert(items)
    q = rng.normal(size=dim).astype(np.float32)
    res = db.query(q, top_k=8, where={"tag": 2})

    host = np.asarray(db._host_vectors)
    mask = np.array([d is not None and d["tag"] == 2 for d in db._docs])
    qn = normalize_batch(q[None])
    ovals, oidxs = numpy_oracle_topk(qn, host, mask, 8)
    want_ids = [db._ids[j] for j in oidxs[0]]
    assert [r[K_ID] for r in res] == want_ids


def test_scores_are_cosine(db_path, rng):
    dim = 12
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path)
    a = rng.normal(size=dim).astype(np.float32)
    b = rng.normal(size=dim).astype(np.float32)
    db.upsert([{K_ID: "a", "_vector_": a}, {K_ID: "b", "_vector_": b}])
    res = db.query(a, top_k=2)
    cos_ab = float(
        np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b))
    )
    by_id = {r[K_ID]: r[K_METRICS] for r in res}
    assert by_id["a"] == pytest.approx(1.0, abs=1e-5)
    assert by_id["b"] == pytest.approx(cos_ab, abs=1e-5)


def test_bf16_storage_mode(db_path, rng):
    """bfloat16 device storage: same winners as f32 on separable data,
    scores within bf16 tolerance (new capability, no reference analog)."""
    dim, n = 32, 150
    items, vecs = make_items(rng, n, dim)
    db32 = PicoVectorDB(embedding_dim=dim, storage_file=db_path + "_f32")
    db16 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path + "_bf16",
        storage_dtype="bfloat16",
    )
    db32.upsert(items)
    db16.upsert(items)
    res32 = db32.query(vecs[5], top_k=1)
    res16 = db16.query(vecs[5], top_k=1)
    assert res16[0][K_ID] == res32[0][K_ID] == "id5"
    assert abs(res16[0][K_METRICS] - 1.0) < 5e-3
    # persistence stays float32 regardless of device storage
    db16.save()
    import numpy as _np

    stored = _np.load(db_path + "_bf16.vecs.npy")
    assert stored.dtype == _np.float32


def test_scan_modes_agree(db_path, rng):
    """All single-device scan modes return the same results (approx_max_k
    is exact on CPU; elsewhere it honors its recall target + rescore)."""
    dim, n = 16, 120
    items, vecs = make_items(rng, n, dim)
    results = {}
    for mode in ("xla", "approx", "auto"):
        db = PicoVectorDB(
            embedding_dim=dim, storage_file=db_path + mode, scan_mode=mode,
        )
        db.upsert(items)
        results[mode] = db.query(vecs[:4], top_k=5)
        assert db._last_topk_strategy == (
            "xla_approx" if mode == "approx" else "xla_topk"
        )
    ids_by_mode = {
        m: [[h[K_ID] for h in row] for row in r] for m, r in results.items()
    }
    assert ids_by_mode["xla"] == ids_by_mode["approx"] == ids_by_mode["auto"]
