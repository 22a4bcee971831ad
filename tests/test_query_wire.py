"""Compact host->device query wire for the batch serving lanes.

New capability with no reference counterpart (the reference never ships
queries across a device boundary): large host numpy batches upload as
float16/bfloat16 and widen on device, halving the dominant transfer on
bandwidth-limited host links (VERDICT r3 item 1). The ranking contract
must be unchanged — queries L2-normalize on device after the cast, so a
per-row prescale into f16's safe band is free for cosine scores.
"""

import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID
from picovdb_tpu.constants import QUERY_WIRE_MIN_Q
from picovdb_tpu.utils import encode_query_wire, normalize_batch
from conftest import make_items


# ---------------------------------------------------------------- encoder

def test_encode_f16_straight_cast(rng):
    v = rng.normal(size=(8, 32)).astype(np.float32)
    w = encode_query_wire(v, "float16")
    assert w.dtype == np.float16
    np.testing.assert_allclose(w.astype(np.float32), v, rtol=2e-3, atol=2e-4)


def test_encode_f16_rescales_out_of_band_rows(rng):
    v = rng.normal(size=(4, 16)).astype(np.float32)
    v[1] *= 1e6   # overflows f16
    v[2] *= 1e-6  # underflows to subnormal noise
    w = encode_query_wire(v, "float16").astype(np.float32)
    assert np.isfinite(w).all()
    # direction (the only thing cosine ranking sees) is preserved per row
    np.testing.assert_allclose(
        normalize_batch(w), normalize_batch(v), rtol=0, atol=2e-3
    )


def test_encode_f16_zero_row_passes_through(rng):
    v = np.zeros((3, 8), dtype=np.float32)
    v[0, 0] = 1e7  # force the rescale branch
    w = encode_query_wire(v, "float16")
    assert not w[1].any() and not w[2].any()


def test_encode_bf16(rng):
    import ml_dtypes

    v = rng.normal(size=(5, 16)).astype(np.float32) * 1e5  # f16 would overflow
    w = encode_query_wire(v, "bfloat16")
    assert w.dtype == ml_dtypes.bfloat16
    np.testing.assert_allclose(
        w.astype(np.float32), v, rtol=1.6e-2, atol=0
    )


def test_encode_int16(rng):
    v = rng.normal(size=(6, 64)).astype(np.float32)
    v[2] *= 1e6  # arbitrary magnitudes are fine: per-row fixed point
    v[4] = 0.0
    w = encode_query_wire(v, "int16")
    assert w.dtype == np.int16
    assert not w[4].any()
    nz = [0, 1, 2, 3, 5]
    np.testing.assert_allclose(
        normalize_batch(w[nz].astype(np.float32)),
        normalize_batch(v[nz]),
        rtol=0, atol=1e-4,
    )


def test_encode_int8(rng):
    v = rng.normal(size=(6, 64)).astype(np.float32)
    v[3] = 0.0  # zero row stays zero (normalizes to e0 downstream)
    w = encode_query_wire(v, "int8")
    assert w.dtype == np.int8
    assert not w[3].any()
    nz = [0, 1, 2, 4, 5]
    np.testing.assert_allclose(
        normalize_batch(w[nz].astype(np.float32)),
        normalize_batch(v[nz]),
        rtol=0, atol=1e-2,
    )


def test_encode_never_mutates_caller(rng):
    v = (rng.normal(size=(4, 8)) * 1e6).astype(np.float32)
    before = v.copy()
    encode_query_wire(v, "float16")
    np.testing.assert_array_equal(v, before)


# ------------------------------------------------------- engine knob logic

def test_wire_auto_threshold(db_path, rng):
    db = PicoVectorDB(embedding_dim=16, storage_file=db_path)
    v = rng.normal(size=(QUERY_WIRE_MIN_Q, 16)).astype(np.float32)
    small = db._wire_encode(v[: QUERY_WIRE_MIN_Q - 1], QUERY_WIRE_MIN_Q - 1)
    assert small.dtype == np.float32  # below the auto threshold: untouched
    big = db._wire_encode(v, QUERY_WIRE_MIN_Q)
    assert big.dtype == np.int16  # auto pick: per-row fixed point


def test_wire_kwarg_and_env(db_path, rng, monkeypatch):
    v = rng.normal(size=(4, 16)).astype(np.float32)
    db = PicoVectorDB(
        embedding_dim=16, storage_file=db_path, query_wire="float16"
    )
    assert db._wire_encode(v, 4).dtype == np.float16  # explicit: any Q
    db32 = PicoVectorDB(
        embedding_dim=16, storage_file=db_path, query_wire="off"
    )
    assert db32._wire_encode(v, 10**9) is v  # disabled

    monkeypatch.setenv("PICOVDB_QUERY_WIRE", "bf16")
    dbe = PicoVectorDB(embedding_dim=16, storage_file=db_path)
    assert dbe._query_wire == "bfloat16"
    # kwarg beats env (reference precedence rule, pico_vdb.py:152-164)
    dbk = PicoVectorDB(
        embedding_dim=16, storage_file=db_path, query_wire="float32"
    )
    assert dbk._query_wire == "float32"

    with pytest.raises(ValueError, match="query_wire"):
        PicoVectorDB(
            embedding_dim=16, storage_file=db_path, query_wire="int7"
        )


def test_wire_passes_device_arrays_through(db_path, rng):
    import jax.numpy as jnp

    db = PicoVectorDB(
        embedding_dim=16, storage_file=db_path, query_wire="float16"
    )
    q = jnp.zeros((4, 16), dtype=jnp.float32)
    assert db._wire_encode(q, 4) is q


# ---------------------------------------------------------- e2e parity

def _parity_store(db_path, rng, n=1500, dim=48, **kw):
    db = PicoVectorDB(embedding_dim=dim, storage_file=db_path, **kw)
    items, vecs = make_items(rng, n, dim)
    db.upsert(items)
    return db, vecs


def test_batched_parity_f16_vs_f32(db_path, rng):
    db, vecs = _parity_store(db_path, rng, query_wire="float16")
    q = rng.normal(size=(70, 48)).astype(np.float32)
    got = db.query_batched(q, top_k=5, batch_size=32)
    db._query_wire = "float32"
    want = db.query_batched(q, top_k=5, batch_size=32)
    assert [[h[K_ID] for h in row] for row in got] == [
        [h[K_ID] for h in row] for row in want
    ]
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            assert abs(g["_metrics_"] - w["_metrics_"]) < 2e-3


def test_batched_parity_int16_vs_f32(db_path, rng):
    db, _ = _parity_store(db_path, rng, query_wire="int16")
    q = rng.normal(size=(70, 48)).astype(np.float32)
    got = db.query_batched(q, top_k=5, batch_size=32)
    db._query_wire = "float32"
    want = db.query_batched(q, top_k=5, batch_size=32)
    assert [[h[K_ID] for h in row] for row in got] == [
        [h[K_ID] for h in row] for row in want
    ]
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            assert abs(g["_metrics_"] - w["_metrics_"]) < 3e-4


def test_batched_int8_wire_high_recall(db_path, rng):
    db, vecs = _parity_store(db_path, rng, query_wire="int8")
    q = (vecs[:40] + 0.05 * rng.normal(size=(40, 48))).astype(np.float32)
    got = db.query_batched(q, top_k=5, batch_size=16)
    db._query_wire = "float32"
    want = db.query_batched(q, top_k=5, batch_size=16)
    overlap = np.mean([
        len({h[K_ID] for h in g} & {h[K_ID] for h in w}) / 5
        for g, w in zip(got, want)
    ])
    assert overlap >= 0.95  # 1-byte wire: near-exact, not bit-exact


def test_columnar_parity_f16_vs_f32(db_path, rng):
    db, _ = _parity_store(db_path, rng, query_wire="float16")
    q = rng.normal(size=(64, 48)).astype(np.float32)
    ids16, sc16 = db.query_columnar(q, top_k=5, batch_size=16)
    db._query_wire = "float32"
    ids32, sc32 = db.query_columnar(q, top_k=5, batch_size=16)
    np.testing.assert_array_equal(ids16, ids32)
    np.testing.assert_allclose(sc16, sc32, rtol=0, atol=2e-3)


def test_batched_parity_filtered(db_path, rng):
    db = PicoVectorDB(
        embedding_dim=32, storage_file=db_path, query_wire="float16"
    )
    items, _ = make_items(
        rng, 800, 32, extra=lambda i: {"grp": i % 4}
    )
    db.upsert(items)
    q = rng.normal(size=(40, 32)).astype(np.float32)
    got = db.query_batched(q, top_k=4, where={"grp": 2}, batch_size=16)
    db._query_wire = "float32"
    want = db.query_batched(q, top_k=4, where={"grp": 2}, batch_size=16)
    assert [[h[K_ID] for h in row] for row in got] == [
        [h[K_ID] for h in row] for row in want
    ]
    for row in got:
        for h in row:
            assert int(h[K_ID][2:]) % 4 == 2


def test_columnar_parity_on_ivf_store(db_path, rng):
    from test_ivf import clustered_data

    vecs, _ = clustered_data(rng, 2000, 32)
    db = PicoVectorDB(
        embedding_dim=32, storage_file=db_path, index="ivf", ivf_nlist=8,
        query_wire="float16",
    )
    db.upsert(
        [{K_ID: f"v{i}", "_vector_": vecs[i]} for i in range(len(vecs))]
    )
    q = (vecs[:24] + 0.01 * rng.normal(size=(24, 32))).astype(np.float32)
    ids16, sc16 = db.query_columnar(q, top_k=5, batch_size=8)
    assert db._last_topk_strategy.startswith("ivf")
    db._query_wire = "float32"
    ids32, sc32 = db.query_columnar(q, top_k=5, batch_size=8)
    np.testing.assert_array_equal(ids16, ids32)
    np.testing.assert_allclose(sc16, sc32, rtol=0, atol=2e-3)


def test_batched_parity_on_mesh_store(db_path, rng):
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs multiple (virtual) devices")
    from picovdb_tpu.parallel import make_mesh

    mesh = make_mesh()
    db = PicoVectorDB(
        embedding_dim=32, storage_file=db_path, mesh=mesh,
        query_wire="float16",
    )
    items, _ = make_items(rng, 640, 32)
    db.upsert(items)
    q = rng.normal(size=(48, 32)).astype(np.float32)
    got = db.query_batched(q, top_k=5, batch_size=16)
    db._query_wire = "float32"
    want = db.query_batched(q, top_k=5, batch_size=16)
    assert [[h[K_ID] for h in row] for row in got] == [
        [h[K_ID] for h in row] for row in want
    ]


def test_int8_rescore_wire_exact_parity(db_path, rng):
    """query_wire='int8_rescore': queries ship on the 1 B wire, the device
    selects top-(k + guard), the host re-ranks exactly on the f32 rows —
    ids AND scores must match the float32 wire bit-for-bit (the rescore
    recomputes scores at f64, same as the oracle)."""
    db, _ = _parity_store(db_path, rng, n=3000, query_wire="int8_rescore")
    q = rng.normal(size=(QUERY_WIRE_MIN_Q + 40, 48)).astype(np.float32)
    got = db.query_batched(q, top_k=5, batch_size=512)
    assert db._last_rescore == "host-wire"
    db._query_wire = "float32"
    want = db.query_batched(q, top_k=5, batch_size=512)
    assert [[h[K_ID] for h in row] for row in got] == [
        [h[K_ID] for h in row] for row in want
    ]
    for g_row, w_row in zip(got, want):
        for g, w in zip(g_row, w_row):
            assert abs(g["_metrics_"] - w["_metrics_"]) < 1e-5


def test_int8_rescore_small_batch_falls_back_to_int16(db_path, rng):
    """Below QUERY_WIRE_MIN_Q the rescore lane does not engage; the wire
    falls back to the recall-1.0 int16 plane, never raw int8."""
    db, _ = _parity_store(db_path, rng, n=600, query_wire="int8_rescore")
    small = db._wire_encode(
        rng.normal(size=(8, 48)).astype(np.float32), 8
    )
    assert small.dtype == np.float32  # below the auto threshold: untouched
    # the 1 B plane requires the caller to declare its rescore lane
    # (query_batched passes rescore=True; query_columnar has no lane and
    # gets int16 — r5 review finding)
    big = db._wire_encode(
        rng.normal(size=(QUERY_WIRE_MIN_Q, 48)).astype(np.float32),
        QUERY_WIRE_MIN_Q, rescore=True,
    )
    assert big.dtype == np.int8

    # lazy (device-born) stores have no authentic f32 host rows: the lane
    # must refuse int8 and ship int16 instead
    db._host_lazy = True
    lazy = db._wire_encode(
        rng.normal(size=(QUERY_WIRE_MIN_Q, 48)).astype(np.float32),
        QUERY_WIRE_MIN_Q, rescore=True,
    )
    assert lazy.dtype == np.int16
    db._host_lazy = False


def test_int8_rescore_with_filters(db_path, rng):
    """The wire-rescore lane composes with ids/where filters: candidates
    come from the filtered set and the exact re-rank preserves them."""
    db, _ = _parity_store(db_path, rng, n=2000, query_wire="int8_rescore")
    allow = [f"id{i}" for i in range(0, 2000, 3)]
    q = rng.normal(size=(QUERY_WIRE_MIN_Q, 48)).astype(np.float32)
    got = db.query_batched(q, top_k=5, ids=allow, batch_size=512)
    db._query_wire = "float32"
    want = db.query_batched(q, top_k=5, ids=allow, batch_size=512)
    assert [[h[K_ID] for h in row] for row in got] == [
        [h[K_ID] for h in row] for row in want
    ]
    for row in got:
        assert all(h[K_ID] in set(allow) for h in row)
