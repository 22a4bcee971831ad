"""storage_dtype="int4": packed-nibble corpus tier (0.5 B/element).

Halves int8 storage again. Two-plane packing: element j < dim/2 in the low
nibble of byte j, j + dim/2 in the high nibble, so a row block unpacks with
two vector ops before the int8 matmul (ops/quant.py int4 layout). The tier
targets HOST-BORN stores: device-side ranking carries ~18x int8's
quantization noise, and the engine's host-f64 rescore (rescore="auto",
tests/test_rescore.py) restores exact ranking against the authoritative
float32 matrix. Host persistence stays float32 (reference byte-compat,
picovdb/pico_vdb.py:374-378 format).
"""

import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID, K_METRICS, K_VECTOR
from picovdb_tpu.utils import normalize_batch

DIM = 128


def _corpus(rng, n=4096, dim=DIM):
    return normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))


def _tie_aware_recall(db, data, q, k=10):
    got = db.query(q, top_k=k)
    stored = normalize_batch(data.copy())
    qn = normalize_batch(np.atleast_2d(q).astype(np.float32))
    s = qn.astype(np.float64) @ stored.astype(np.float64).T
    kth = -np.sort(-s, axis=1)[:, k - 1]
    return sum(
        sum(s[i, int(r[K_ID])] >= kth[i] for r in res)
        for i, res in enumerate(got)
    ) / (len(q) * k)


def test_pack_roundtrip_and_quantization_bound(rng):
    import jax.numpy as jnp

    from picovdb_tpu.ops.quant import quantize_rows_i4, unpack_i4

    V = _corpus(rng, n=512)
    v4, vs = quantize_rows_i4(jnp.asarray(V))
    assert np.asarray(v4).shape == (512, DIM // 2)
    deq = np.asarray(unpack_i4(v4)).astype(np.float32) * np.asarray(vs)[:, None]
    # per-element error bounded by half the row's quantization step
    err = np.abs(deq - V)
    assert (err <= np.asarray(vs)[:, None] / 2 + 1e-6).all()
    # nibbles use the symmetric [-7, 7] range
    up = np.asarray(unpack_i4(v4))
    assert up.min() >= -7 and up.max() <= 7


def test_int4_end_to_end(db_path, rng):
    n, k = 4096, 5
    V = _corpus(rng, n=n)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int4")
    db.upsert([{K_ID: str(i), K_VECTOR: V[i], "g": i % 3} for i in range(n)])

    hits = db.query(V[7], top_k=k)
    assert db._dev.vectors.shape == (db._dev.cap, DIM // 2)
    assert db._dev.vstore_scale is not None
    assert hits[0][K_ID] == "7"
    # auto rescore: exact f32 scores despite 4-bit storage
    assert db.last_query_debug()["rescore"] == "host"
    assert abs(hits[0][K_METRICS] - 1.0) < 1e-5

    fh = db.query(V[7], top_k=k, where={"g": 1})
    assert fh and all(h["g"] == 1 for h in fh)

    db.delete(["7"])
    hits2 = db.query(V[7], top_k=k)
    assert all(h[K_ID] != "7" for h in hits2)

    # disk stays float32: reload under f32 storage sees full precision
    db.save()
    db2 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path)
    assert db2.count() == n - 1
    got = db2.get("11", include_vector=True)
    stored = normalize_batch(V[11][None].copy())[0]
    np.testing.assert_allclose(got[K_VECTOR], stored, atol=1e-6)


def test_host_rescore_restores_exact_recall(db_path, rng):
    V = _corpus(rng)
    q = V[rng.integers(0, len(V), 16)]
    dev = PicoVectorDB(embedding_dim=DIM, storage_file=db_path + "_d",
                       storage_dtype="int4", rescore="device")
    dev.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    host = PicoVectorDB(embedding_dim=DIM, storage_file=db_path + "_h",
                        storage_dtype="int4", rescore="host")
    host.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    r_dev = _tie_aware_recall(dev, V, q)
    r_host = _tie_aware_recall(host, V, q)
    # 4-bit ranking noise is large even on random data; the host-f64
    # rescore removes it entirely
    assert r_dev < 0.95
    assert r_host == 1.0


def test_wide_topk_falls_back(db_path, rng):
    V = _corpus(rng, n=2048)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int4", rescore="device")
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    hits = db.query(V[5], top_k=600)
    assert len(hits) == 600 and hits[0][K_ID] == "5"


def test_device_born_ingest(db_path, rng):
    import jax.numpy as jnp

    V = _corpus(rng, n=512)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int4")
    db.ingest_device(jnp.asarray(V), ids=[str(i) for i in range(len(V))])
    hits = db.query(V[3], top_k=3)
    assert hits[0][K_ID] == "3"
    # no authentic f32 anywhere -> the rescore tier stands down
    assert db.last_query_debug()["rescore"] is None
    # single-row fetch unpacks + dequantizes (within one quantization step)
    row = db.get("3", include_vector=True)[K_VECTOR]
    stored = normalize_batch(V[3][None].copy())[0]
    assert np.abs(row - stored).max() < float(db._dev.vstore_scale[3])


def test_device_born_ingest_prepacked(db_path, rng):
    """ingest_device with pre-quantized PACKED (n, dim//2) input + scales:
    the path that builds capacity-size corpora chunk-wise on device
    without any (n, dim) f32 array ever existing."""
    import jax
    import jax.numpy as jnp

    from picovdb_tpu.ops.quant import quantize_rows_i4

    n = 512
    V = _corpus(rng, n=n)
    v4, vs = quantize_rows_i4(jnp.asarray(V))
    assert v4.shape == (n, DIM // 2)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int4")
    db.ingest_device(jax.device_put(v4), ids=[str(i) for i in range(n)],
                     normalize=False, scales=jax.device_put(vs))
    hits = db.query(V[3], top_k=3)
    assert hits[0][K_ID] == "3"
    # packed input must match an unpacked-ingest store bit-for-bit
    db2 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path + "_u",
                       storage_dtype="int4")
    db2.ingest_device(jnp.asarray(V), ids=[str(i) for i in range(n)])
    np.testing.assert_array_equal(
        np.asarray(db._dev.vectors), np.asarray(db2._dev.vectors))
    # wrong (unpacked) width with scales is rejected with the packed dim
    fresh = PicoVectorDB(embedding_dim=DIM, storage_file=db_path + "_w",
                         storage_dtype="int4")
    ids_n = [str(i) for i in range(n)]
    with pytest.raises(ValueError, match=str(DIM // 2)):
        fresh.ingest_device(jnp.asarray(V), ids=ids_n,
                            normalize=False, scales=jax.device_put(vs))
    # pre-quantized rows are already normalized: normalize=True (the
    # default) would silently do nothing, so it is rejected up front
    with pytest.raises(ValueError, match="normalize=False"):
        fresh.ingest_device(jax.device_put(v4), ids=ids_n,
                            scales=jax.device_put(vs))
    # scales must be one-per-row
    with pytest.raises(ValueError, match="one per row"):
        fresh.ingest_device(jax.device_put(v4), ids=ids_n,
                            normalize=False,
                            scales=jax.device_put(vs[:-1]))
    # packed rows must be int8 bytes
    with pytest.raises(ValueError, match="int8"):
        fresh.ingest_device(jnp.asarray(v4, dtype=jnp.float32)[:, :DIM // 2],
                            ids=ids_n, normalize=False,
                            scales=jax.device_put(vs))


def test_int4_rejects_odd_dim(db_path):
    with pytest.raises(ValueError, match="even embedding_dim"):
        PicoVectorDB(embedding_dim=127, storage_file=db_path,
                     storage_dtype="int4")


@pytest.mark.parametrize("scan_mode", ["auto", "xla"])
def test_int4_storage_mesh(db_path, rng, scan_mode):
    """int4 storage over a device mesh: packed (cap, dim//2) rows + per-row
    scales shard together; per-shard nibble-kernel selection + dequant
    rescore merges over the cross-device top-k.
    Extends the one-chip capacity ladder (f32 3M -> bf16 4M -> int8 12.58M
    -> int4 25.17M) onto the mesh: ~25M rows/chip x shards."""
    from picovdb_tpu.parallel import make_mesh

    mesh = make_mesh()
    n, k = 4096, 5
    V = rng.normal(size=(n, DIM)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path, mesh=mesh,
                      storage_dtype="int4", scan_mode=scan_mode)
    db.upsert_columnar(V.copy(), ids=[str(i) for i in range(n)])
    res = db.query(V[7], top_k=k)
    assert res[0][K_ID] == "7"
    assert "i4stor" in db._dev.last_strategy
    assert db._dev.vectors.shape == (db._dev.cap, DIM // 2)
    # host-born store: the host-f64 rescore tier applies under a mesh
    # too, so ranking (and recall) is exact despite 4-bit storage
    assert db.last_query_debug()["rescore"] == "host"
    assert abs(res[0][K_METRICS] - 1.0) < 1e-5
    q = V[rng.integers(0, n, 8)]
    assert _tie_aware_recall(db, V, q) == 1.0
    # mutations keep exact semantics (each row owns its scale)
    db.delete(["7"])
    assert db.query(V[7], top_k=1)[0][K_ID] != "7"
    db.upsert([{K_ID: "7", K_VECTOR: V[7]}])
    assert db.query(V[7], top_k=1)[0][K_ID] == "7"
    # persistence stays float32: reload into the same mesh layout
    db.save()
    db2 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path, mesh=mesh,
                       storage_dtype="int4", scan_mode=scan_mode)
    assert db2.query(V[9], top_k=1)[0][K_ID] == "9"
    assert db2.count() == n


def test_int4_mesh_ivf_request_serves_exact_below_min_dim(db_path, rng):
    """Below IVF_I8_MIN_DIM (no PICOVDB_IVF_I8 opt-in) int4+ivf falls back
    to the sharded exact scan — the int8-only postings' column
    quantization would stack on the 4-bit storage quantization."""
    from picovdb_tpu.parallel import make_mesh

    V = _corpus(rng, n=2048)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      mesh=make_mesh(), storage_dtype="int4", index="ivf")
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    hits = db.query(V[9], top_k=3)
    assert hits[0][K_ID] == "9"
    assert db._ivf is None  # warned + stayed on the sharded exact scan


def test_int4_ivf_request_serves_exact_below_min_dim(db_path, rng):
    V = _corpus(rng, n=2048)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int4", index="ivf")
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    hits = db.query(V[9], top_k=3)
    assert hits[0][K_ID] == "9"
    assert db._ivf is None  # warned + stayed exact


def test_int4_ivf_serves_probed(db_path, rng, monkeypatch):
    """int4 + index='ivf' (postings enabled): the int8-only layout's
    selection probes int8 postings and the exact rescore unpacks the
    PACKED int4 corpus rows by slot — full-probe results match the int4
    exact scan, mutations route through the in-place frozen-scale path,
    and the sidecar reloads warm."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # enable below IVF_I8_MIN_DIM
    V = _corpus(rng, n=2048)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int4", index="ivf", ivf_nlist=16)
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None  # i8-only
    hits = db.query(V[9], top_k=3, ef_search=1000)
    assert db._last_topk_strategy == "ivf_i8"
    assert hits[0][K_ID] == "9"
    exact = db.query(V[9], top_k=3, ef_search=1000, where=lambda d: True)
    assert {h[K_ID] for h in hits} == {h[K_ID] for h in exact}

    new = _corpus(rng, n=2)
    db.upsert([{K_ID: f"n{j}", K_VECTOR: new[j]} for j in range(2)])
    db.delete(["9"])
    gone = db.query(V[9], top_k=3, ef_search=1000)
    assert db._last_ann_rebuild_mode == "incremental"
    assert all(h[K_ID] != "9" for h in gone)
    assert db.query(new[0], top_k=1, ef_search=1000)[0][K_ID] == "n0"

    db.save()
    db2 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                       storage_dtype="int4", index="ivf", ivf_nlist=16)
    assert db2._ivf is not None and db2._ivf.vectors is None
    assert db2.query(new[1], top_k=1, ef_search=1000)[0][K_ID] == "n1"


def test_int4_mesh_ivf_serves_probed(db_path, rng, monkeypatch):
    """int4 + ivf over the 8-device mesh: per-shard int8 postings select,
    the shard-local rescore unpacks each shard's slice of the PACKED int4
    corpus, and the cross-device merge returns global slots."""
    from picovdb_tpu.parallel import make_mesh

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    V = _corpus(rng, n=2048)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      mesh=make_mesh(), storage_dtype="int4", index="ivf",
                      ivf_nlist=16)
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None
    hits = db.query(V[9], top_k=3, ef_search=1000)
    assert db._last_topk_strategy == "ivf_i8"
    assert hits[0][K_ID] == "9"
    exact = db.query(V[9], top_k=3, ef_search=1000, where=lambda d: True)
    assert {h[K_ID] for h in hits} == {h[K_ID] for h in exact}

    new = _corpus(rng, n=2)
    db.upsert([{K_ID: f"n{j}", K_VECTOR: new[j]} for j in range(2)])
    db.delete(["9"])
    gone = db.query(V[9], top_k=3, ef_search=1000)
    assert db._last_ann_rebuild_mode == "incremental"
    assert all(h[K_ID] != "9" for h in gone)
    assert db.query(new[0], top_k=1, ef_search=1000)[0][K_ID] == "n0"


def test_int4_memmap_capacity_mode(db_path, rng):
    V = _corpus(rng, n=1024)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int4", use_memmap=True, capacity=2048)
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    q = V[rng.integers(0, len(V), 8)]
    assert _tie_aware_recall(db, V, q) == 1.0
    db.save()
    db2 = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                       storage_dtype="int4", use_memmap=True, capacity=2048)
    assert db2.count() == 1024
    assert db2.query(V[5], top_k=1)[0][K_ID] == "5"


def test_serial_loop_routes_int4(db_path, rng):
    V = _corpus(rng, n=2048)
    db = PicoVectorDB(embedding_dim=DIM, storage_file=db_path,
                      storage_dtype="int4")
    db.upsert([{K_ID: str(i), K_VECTOR: V[i]} for i in range(len(V))])
    vals, idxs = db.query_serial_loop(V[:4], top_k=3)
    assert vals.shape == (4, 3) and idxs.shape == (4, 3)
    assert (idxs[:, 0] == np.arange(4)).all()
    assert db._dev.last_strategy == "i4stor_xla_loop"
