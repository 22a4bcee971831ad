"""storage_dtype="int8": per-row-quantized corpus tier.

Quarter the HBM residency of float32 (the single-chip capacity ceiling
becomes ~12M x 1024 rows); selection runs the int8 kernels, ranking is
a dequantized rescore (score quantization ~vscale/2 per element — at
dim >= 128 tighter than bfloat16 storage's documented behavior).
Per-row scales give exact mutation semantics (each upserted row owns its
scale). Host persistence stays float32 (reference byte-compat).
"""

import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID, K_METRICS, K_VECTOR
from picovdb_tpu.utils import normalize_batch

DIM = 128


def oracle_topk(q, V, k):
    qn = normalize_batch(q[None, :].astype(np.float32))[0]
    scores = qn @ normalize_batch(V.copy()).T
    idx = np.argsort(-scores)[:k]
    return idx, scores


def test_int8_storage_end_to_end(db_path, rng):
    n, k = 2048, 5
    V = rng.normal(size=(n, DIM)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int8")
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(n)])

    hits = db.query(V[7], top_k=k)
    # device sync is lazy (reference's lazy FAISS rebuild analog): the
    # int8 mirror + per-row scales exist after the first query
    assert db._dev.vectors.dtype == np.int8
    assert db._dev.vstore_scale is not None
    oidx, scores = oracle_topk(V[7], V, k)
    assert hits[0][K_ID] == str(oidx[0])
    # dequantized rescore: scores within the storage quantization
    for h in hits:
        assert abs(h[K_METRICS] - scores[int(h[K_ID])]) < 3e-3

    # filtered query -> int8 XLA path
    docs = [{K_ID: str(i), K_VECTOR: V[i], "g": i % 3} for i in range(n)]
    db.upsert(docs)
    fh = db.query(V[7], top_k=k, where={"g": 1})
    assert fh and all(h["g"] == 1 for h in fh)
    assert db._last_topk_strategy == "i8stor_xla"

    # delete + requery
    db.delete([str(int(hits[0][K_ID]))])
    hits2 = db.query(V[7], top_k=k)
    assert all(h[K_ID] != hits[0][K_ID] for h in hits2)

    # persistence: disk stays f32 (reference-compatible), reload requantizes
    db.save()
    db2 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                       storage_dtype="int8")
    assert db2.count() == db.count()
    hits3 = db2.query(V[9], top_k=1)
    oidx9, _ = oracle_topk(V[9], V, 1)
    assert hits3[0][K_ID] == str(oidx9[0])
    # and a float32 process can open the same files
    db3 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path)
    assert db3.count() == db.count()


def test_int8_storage_routing_and_recall(db_path, rng):
    n, k = 32_768, 8
    V = rng.normal(size=(n, DIM)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int8")
    db.upsert_columnar(V, ids=[str(i) for i in range(n)], copy=False)

    db.query(V[3], top_k=3)
    assert db._last_topk_strategy == "i8stor_xla"
    out = db.query(V[:64], top_k=k)
    assert db._last_topk_strategy == "i8stor_xla"
    Vn = normalize_batch(V.copy())
    recall = np.mean([
        len({int(h[K_ID]) for h in out[i]}
            & set(np.argsort(-(Vn[i] @ Vn.T))[:k].tolist())) / k
        for i in range(32)
    ])
    assert recall >= 0.95, recall


def test_int8_storage_mutation_semantics(db_path, rng):
    """Per-row scales: an upserted outlier row is exactly representable."""
    n = 256
    V = rng.normal(size=(n, DIM)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int8")
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(n)])
    big = np.zeros(DIM, dtype=np.float32)
    big[3] = 100.0  # normalizes to e3 — extreme per-row scale
    db.upsert([{K_ID: "big", K_VECTOR: big}])
    res = db.query(big, top_k=1)
    assert res[0][K_ID] == "big"
    assert res[0][K_METRICS] > 0.99


@pytest.mark.parametrize("scan_mode", ["auto", "xla"])
def test_int8_storage_mesh(db_path, rng, scan_mode):
    """int8 storage over a device mesh: rows + per-row scales shard
    together; per-shard int8 selection + dequant rescore merges over the
    cross-device top-k exactly like the f32 sharded path."""
    from picovdb_tpu.parallel import make_mesh

    mesh = make_mesh()
    n, k = 4096, 5
    V = rng.normal(size=(n, DIM)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path, mesh=mesh,
                      storage_dtype="int8", scan_mode=scan_mode)
    db.upsert_columnar(V.copy(), ids=[str(i) for i in range(n)])
    res = db.query(V[7], top_k=k)
    assert res[0][K_ID] == "7" and res[0][K_METRICS] > 0.99
    assert "i8stor" in db._dev.last_strategy
    oid, _ = oracle_topk(V[7], V, k)
    got = {int(r[K_ID]) for r in res}
    assert len(got & set(oid.tolist())) >= k - 1  # storage-precision ties
    # mutations keep exact semantics (each row owns its scale)
    db.delete(["7"])
    assert db.query(V[7], top_k=1)[0][K_ID] != "7"
    db.upsert([{K_ID: "7", K_VECTOR: V[7]}])
    assert db.query(V[7], top_k=1)[0][K_ID] == "7"
    # persistence stays float32: reload into the same mesh layout
    db.save()
    db2 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path, mesh=mesh,
                       storage_dtype="int8", scan_mode=scan_mode)
    assert db2.query(V[9], top_k=1)[0][K_ID] == "9"
    assert db2.count() == n


def test_int8_storage_ivf(db_path, rng, monkeypatch):
    """index="ivf" on an int8 store: int8-only postings, dequant rescore
    by slot against the int8 corpus."""
    from test_ivf import clustered_data

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # force below IVF_I8_MIN_DIM
    n, k = 4096, 5
    V, _ = clustered_data(rng, n, DIM)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int8", index="ivf", ivf_nlist=16,
                      ivf_nprobe=16)  # probe everything
    db.upsert_columnar(V.copy(), ids=[str(i) for i in range(n)], copy=False)
    res = db.query(V[33], top_k=k)
    assert db._ivf is not None and db._ivf.vectors is None  # i8-only
    assert db._last_topk_strategy == "ivf_i8"
    Vn = normalize_batch(V.copy())
    oidx = set(np.argsort(-(Vn[33] @ Vn.T))[:k].tolist())
    got = {int(h[K_ID]) for h in res}
    assert len(got & oidx) / k >= 0.8, (got, oidx)


def test_int8_storage_device_born_ingest(db_path, rng):
    """ingest_device with pre-quantized (v8, scales) input: queries work,
    lazy host materialization dequantizes (get/save see true values)."""
    import jax
    import jax.numpy as jnp

    from picovdb_tpu.ops.quant import quantize_rows_i8

    n = 512
    V = normalize_batch(rng.normal(size=(n, DIM)).astype(np.float32))
    v8, vs = quantize_rows_i8(jnp.asarray(V))
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int8")
    db.ingest_device(jax.device_put(v8), ids=[str(i) for i in range(n)],
                     normalize=False, scales=jax.device_put(vs))
    res = db.query(V[5], top_k=1)
    assert res[0][K_ID] == "5" and res[0][K_METRICS] > 0.99
    rec = db.get("5", include_vector=True)
    np.testing.assert_allclose(rec[K_VECTOR], V[5], atol=6e-3)
    db.save()
    db2 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                       storage_dtype="int8")
    res2 = db2.query(V[5], top_k=1)
    assert res2[0][K_ID] == "5"


def test_int8_storage_low_dim_ivf_serves_exact(db_path, rng):
    """Below IVF_I8_MIN_DIM (no PICOVDB_IVF_I8 force) an int8 store with
    index="ivf" warns and serves exact: the postings' column quantization
    would stack on the storage quantization (review finding)."""
    from test_ivf import clustered_data

    n = 2048
    V, _ = clustered_data(rng, n, DIM)  # DIM=128 < IVF_I8_MIN_DIM
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int8", index="ivf", ivf_nlist=16)
    db.upsert_columnar(V.copy(), ids=[str(i) for i in range(n)], copy=False)
    res = db.query(V[33], top_k=1)
    assert db._ivf is None
    assert res[0][K_ID] == "33"
    assert db._last_topk_strategy.startswith("i8stor")
