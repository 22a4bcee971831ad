"""Device-born ingestion (`ingest_device`): a device-resident embedding
matrix becomes the corpus with no host round trip; the host matrix stays
lazy until something needs it (save, include_vector getters, mutation).

New capability with no reference counterpart — the reference's only bulk
load goes through host numpy (picovdb/pico_vdb.py:403-498). Parity target:
after ingestion the store behaves exactly like one built via
upsert_columnar over the same data.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from picovdb_tpu import PicoVectorDB, K_ID, K_METRICS, K_VECTOR


def _mk(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, dim)).astype(np.float32)


def _ingested_db(db_path, n=64, dim=32, **kw):
    data = _mk(n, dim)
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path, **kw)
    rep = db.ingest_device(
        jnp.asarray(data), ids=[f"r{i}" for i in range(n)],
        metadata=[{"tag": i % 4} for i in range(n)],
    )
    return db, data, rep


def test_ingest_matches_columnar_queries(db_path):
    n, dim = 64, 32
    data = _mk(n, dim)
    db_dev, _, rep = _ingested_db(db_path + "_dev", n=n, dim=dim)
    db_host = PicoVectorDB(embedding_dim=dim, storage_file=db_path + "_host")
    db_host.upsert_columnar(
        data.copy(), ids=[f"r{i}" for i in range(n)],
        metadata=[{"tag": i % 4} for i in range(n)],
    )
    assert rep["insert"] == [f"r{i}" for i in range(n)]
    assert len(db_dev) == n and db_dev.count() == n
    q = _mk(5, dim, seed=1)
    r_dev = db_dev.query(q, top_k=7)
    r_host = db_host.query(q, top_k=7)
    for a, b in zip(r_dev, r_host):
        assert [x[K_ID] for x in a] == [y[K_ID] for y in b]
        np.testing.assert_allclose(
            [x[K_METRICS] for x in a], [y[K_METRICS] for y in b], atol=1e-5
        )


def test_ingest_lazy_host_materializes_for_getters(db_path):
    db, data, _ = _ingested_db(db_path)
    assert db._host_lazy
    rec = db.get("r3", include_vector=True)
    expect = data[3] / np.linalg.norm(data[3])
    np.testing.assert_allclose(rec[K_VECTOR], expect, atol=1e-5)
    # single-row getters do NOT force full materialization
    assert db._host_lazy
    assert rec["tag"] == 3


def test_ingest_save_reload_roundtrip(db_path):
    db, data, _ = _ingested_db(db_path)
    db.save()
    assert not db._host_lazy  # save materialized the matrix
    db2 = PicoVectorDB(embedding_dim=32, storage_file=db_path)
    assert db2.count() == 64
    q = data[10] / np.linalg.norm(data[10])
    top = db2.query(q, top_k=1)[0]
    assert top[K_ID] == "r10"
    assert top[K_METRICS] == pytest.approx(1.0, abs=1e-5)


def test_ingest_then_mutate(db_path):
    """Mutations on a device-born store must NOT materialize the host
    matrix (an O(corpus) device->host fetch — measured OOM at the 8M int4
    capacity tier): they ride the O(changed) host overlay instead, and
    the store stays lazy until a full-matrix consumer (save/vacuum/full
    re-upload) pays the one-time materialization."""
    db, data, _ = _ingested_db(db_path)
    db.delete(["r0", "r1"])
    assert db._host_lazy  # delete rides the overlay, no materialization
    assert db.count() == 62
    db.upsert([{K_ID: "extra", K_VECTOR: np.ones(32, dtype=np.float32)}])
    assert db._host_lazy
    res = db.query(np.ones(32, dtype=np.float32), top_k=1)[0]
    assert res[K_ID] == "extra"
    ids = {r[K_ID] for r in db.get_all()}
    assert "r0" not in ids and "extra" in ids
    # the overlaid row reads back exactly (point read prefers the overlay)
    got = db.get(["extra"], include_vector=True)[0]
    ones = np.ones(32, dtype=np.float32)
    np.testing.assert_allclose(
        got[K_VECTOR], ones / np.linalg.norm(ones), rtol=1e-6
    )
    # a full-matrix consumer (save) materializes and merges the overlay
    db.save()
    assert not db._host_lazy and not db._host_overlay
    db2 = PicoVectorDB(embedding_dim=32, storage_file=db_path)
    ids2 = {r[K_ID] for r in db2.get_all()}
    assert "r0" not in ids2 and "extra" in ids2


def test_ingest_filters_and_where(db_path):
    db, data, _ = _ingested_db(db_path)
    hits = db.query(data[8], top_k=4, where={"tag": 8 % 4})
    assert hits and all(h["tag"] == 0 for h in hits)
    assert hits[0][K_ID] == "r8"


def test_ingest_rejects_bad_inputs(db_path):
    data = _mk(8, 16)
    db = PicoVectorDB(embedding_dim=16, storage_file=db_path)
    with pytest.raises(ValueError, match="jax.Array"):
        db.ingest_device(data, ids=[str(i) for i in range(8)])
    dev = jnp.asarray(data)
    with pytest.raises(ValueError, match="one id per row"):
        db.ingest_device(dev, ids=["a", "b"])
    with pytest.raises(ValueError, match="unique"):
        db.ingest_device(dev, ids=["a"] * 8)
    with pytest.raises(ValueError, match="last dim"):
        db.ingest_device(jnp.asarray(_mk(8, 4)),
                         ids=[str(i) for i in range(8)])
    db.upsert([{K_ID: "x", K_VECTOR: data[0]}])
    with pytest.raises(ValueError, match="empty"):
        db.ingest_device(dev, ids=[str(i) for i in range(8)])


def test_ingest_zero_rows_map_to_e0(db_path):
    dim = 16
    data = np.zeros((2, dim), dtype=np.float32)
    data[1, 3] = 2.0
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path)
    db.ingest_device(jnp.asarray(data), ids=["z", "a"])
    rec = db.get("z", include_vector=True)
    e0 = np.zeros(dim, dtype=np.float32)
    e0[0] = 1.0
    np.testing.assert_allclose(rec[K_VECTOR], e0, atol=1e-6)


def test_ingest_bf16_storage(db_path):
    db, data, _ = _ingested_db(db_path, storage_dtype="bfloat16")
    q = data[5] / np.linalg.norm(data[5])
    top = db.query(q, top_k=1)[0]
    assert top[K_ID] == "r5"
    assert top[K_METRICS] == pytest.approx(1.0, abs=2e-2)
    db.save()  # persists bf16-rounded rows (documented deviation)
    db2 = PicoVectorDB(embedding_dim=32, storage_file=db_path)
    assert db2.query(q, top_k=1)[0][K_ID] == "r5"


def test_ingest_on_mesh(db_path):
    from picovdb_tpu.parallel import make_mesh

    mesh = make_mesh(4)
    data = _mk(96, 32)
    db = PicoVectorDB(embedding_dim=32, storage_file=db_path, mesh=mesh)
    db.ingest_device(jnp.asarray(data), ids=[f"m{i}" for i in range(96)])
    ref = PicoVectorDB(embedding_dim=32, storage_file=db_path + "_ref")
    ref.upsert_columnar(data.copy(), ids=[f"m{i}" for i in range(96)])
    q = _mk(3, 32, seed=9)
    for a, b in zip(db.query(q, top_k=5), ref.query(q, top_k=5)):
        assert [x[K_ID] for x in a] == [y[K_ID] for y in b]


def test_ingest_ivf_tier_builds_from_device(db_path):
    data = _mk(256, 16, seed=2)
    db = PicoVectorDB(
        embedding_dim=16, storage_file=db_path, index="ivf", ivf_nlist=8
    )
    db.ingest_device(jnp.asarray(data), ids=[f"v{i}" for i in range(256)])
    # ANN build is lazy (reference: picovdb/pico_vdb.py:660-665) and runs
    # from the device mirror on the first query — no host upload happens.
    assert db._ivf is None and db._dirty
    q = data[33] / np.linalg.norm(data[33])
    assert db.query(q, top_k=1)[0][K_ID] == "v33"
    assert db._ivf is not None
    assert db._last_ann_rebuild_mode == "full"
    assert db._host_lazy  # the lazy sync never pulled the corpus to host


def test_ingest_prenormalized_no_normalize(db_path):
    """normalize=False adopts pre-normalized rows as-is (the chunk-wise
    storage-dtype generation path used at 4M x 1024, where a f32
    intermediate would not fit HBM)."""
    n, dim = 32, 16
    data = _mk(n, dim)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path)
    db.ingest_device(jnp.asarray(data), ids=[f"p{i}" for i in range(n)],
                     normalize=False)
    top = db.query(data[4], top_k=1)[0]
    assert top[K_ID] == "p4"
    assert top[K_METRICS] == pytest.approx(1.0, abs=1e-5)
    rec = db.get("p9", include_vector=True)
    np.testing.assert_allclose(rec[K_VECTOR], data[9], atol=1e-6)


def test_ingest_host_shadow_keeps_authentic_f32(db_path):
    """host_shadow=True (VERDICT r3 item 3): the pre-cast normalized f32
    rows become the host matrix at ingest time — no lossy round trip, no
    lazy fetch — and they persist, so a reload serves exact ranking too."""
    n, dim = 48, 32
    data = _mk(n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, storage_dtype="int8",
    )
    db.ingest_device(
        jnp.asarray(data), ids=[f"s{i}" for i in range(n)],
        host_shadow=True,
    )
    assert not db._host_lazy and not db._host_f32_lossy
    expect = data / np.linalg.norm(data, axis=1, keepdims=True)
    np.testing.assert_allclose(db._host_vectors, expect, atol=1e-6)
    rec = db.get("s7", include_vector=True)
    np.testing.assert_allclose(rec[K_VECTOR], expect[7], atol=1e-6)

    db.save()
    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, storage_dtype="int8",
    )
    assert not db2._host_f32_lossy  # persisted rows are authentic f32
    np.testing.assert_allclose(db2._host_vectors[:n], expect, atol=1e-6)


def test_ingest_host_shadow_store_mutates_like_host_born(db_path):
    """After a shadowed ingest, deletes/upserts hit the in-RAM f32 matrix
    directly (no device fetch) and rescore keeps applying."""
    n, dim = 40, 16
    data = _mk(n, dim)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, storage_dtype="bfloat16",
        rescore="host",
    )
    db.ingest_device(
        jnp.asarray(data), ids=[f"m{i}" for i in range(n)],
        host_shadow=True,
    )
    db.delete(["m0"])
    db.upsert([{K_ID: "extra", K_VECTOR: np.ones(dim, dtype=np.float32)}])
    res = db.query(np.ones(dim, dtype=np.float32), top_k=1)[0]
    assert res[K_ID] == "extra"
    assert db.last_query_debug()["rescore"] == "host"
    assert all(r[K_ID] != "m0" for r in db.query(data[0], top_k=5))


def test_ingest_host_shadow_rejects_prequantized(db_path):
    """Pre-quantized ingest never materializes f32 rows, so asking for a
    shadow is a contract error, not a silent downgrade."""
    from picovdb_tpu.ops.quant import quantize_rows_i8

    n, dim = 16, 16
    data = _mk(n, dim)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    v8, scales = quantize_rows_i8(jnp.asarray(data))
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, storage_dtype="int8",
    )
    with pytest.raises(ValueError, match="host_shadow"):
        db.ingest_device(
            v8, ids=[str(i) for i in range(n)], normalize=False,
            scales=scales, host_shadow=True,
        )


@pytest.mark.parametrize("sdt", ["float32", "bfloat16", "int8", "int4"])
def test_batched_vector_getters_match_per_row(db_path, sdt):
    """get/get_all(include_vector=True) on a lazy (device-born) store use
    one chunked device gather (engine._host_rows_batch); rows must match
    the per-row `_host_row` fetch exactly for every storage tier, with
    overlay mutations (upsert/delete while lazy) overriding the mirror."""
    n, dim = 48, 32
    data = _mk(n, dim, seed=3)
    db = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path, storage_dtype=sdt
    )
    db.ingest_device(
        jnp.asarray(data), ids=[f"g{i}" for i in range(n)],
        metadata=[{"i": i} for i in range(n)],
    )
    assert db._host_lazy
    # overlay rows: one update + one delete while lazy
    db.upsert([{K_ID: "g5", K_VECTOR: np.ones(dim, dtype=np.float32)}])
    db.delete(["g7"])
    assert db._host_lazy
    recs = db.get_all(include_vector=True)
    assert len(recs) == n - 1
    for rec in recs:
        idx = db._id2idx[rec[K_ID]]
        np.testing.assert_allclose(
            rec[K_VECTOR], db._host_row(idx), atol=0, rtol=0
        )
    # list-form get batches through the same path
    some = [f"g{i}" for i in range(0, n, 5) if i != 7]
    recs2 = db.get(some, include_vector=True)
    assert [r[K_ID] for r in recs2] == some
    for rec in recs2:
        idx = db._id2idx[rec[K_ID]]
        np.testing.assert_allclose(
            rec[K_VECTOR], db._host_row(idx), atol=0, rtol=0
        )
    # non-lazy store (host-born): same records, bulk numpy path
    db2 = PicoVectorDB(
        embedding_dim=dim, storage_file=db_path + "_h", storage_dtype=sdt
    )
    db2.upsert_columnar(
        data.copy(), ids=[f"g{i}" for i in range(n)],
        metadata=[{"i": i} for i in range(n)],
    )
    recs3 = db2.get_all(include_vector=True)
    for rec in recs3:
        idx = db2._id2idx[rec[K_ID]]
        np.testing.assert_allclose(
            rec[K_VECTOR], db2._host_row(idx), atol=0, rtol=0
        )
