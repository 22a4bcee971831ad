"""Worker process for tests/test_multihost_procs.py.

Runs as one of N real OS processes under `jax.distributed` (Gloo-backed CPU
collectives): loads its own shard of a store saved with `save(shards=N)`,
joins the global row-sharded corpus array, and answers a sharded top-k
query whose merge crosses process boundaries.

Modes (argv[6], default "exact") — VERDICT r3 item 5 extended the original
exact-f32 merge to the remaining mesh lanes:
  * exact — f32 corpus, `make_sharded_topk` cross-process merge
  * i4    — packed-nibble int4 STORAGE lane (`storage_i4=True`): per-shard
            dequantizing exact select + the same ICI merge
  * ivf   — `ShardedIVF` build + full-probe search across processes, then
            one INCREMENTAL `update()` epoch (per-shard overflow regions)
            re-served at oracle parity
  * ivf8  — int8-only `ShardedIVF` layout (per-shard int8 postings +
            LOCAL-slot exact rescore from the sharded corpus), then one
            in-place frozen-scale requantize `update()` epoch

Usage: python multihost_worker.py <pid> <nprocs> <port> <store_base> <dim>
       [mode]
"""

import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def _oracle_topk(qn, rows, k, live=None):
    s = qn @ rows.T
    if live is not None:
        s = np.where(live[None, :], s, -np.inf)
    want = np.argsort(-s, axis=1)[:, :k]
    return s, want


def run_exact(mesh, vectors, mask, full, qn, q_rep):
    from picovdb_tpu.parallel.sharded_query import make_sharded_topk

    fn = make_sharded_topk(mesh, "shard", 5)
    vals, idx = fn(q_rep, vectors, mask)
    got = np.asarray(jax.device_get(idx))
    assert got.shape == (qn.shape[0], 5), got.shape
    _, want = _oracle_topk(qn, full, 5)
    np.testing.assert_array_equal(got, want)
    vals_np = np.asarray(jax.device_get(vals))
    np.testing.assert_allclose(
        vals_np, np.take_along_axis(qn @ full.T, want, axis=1), atol=1e-5
    )


def run_i4(mesh, full, qn, q_rep):
    """Packed int4 storage lane: every process quantizes the identical
    corpus, shards the packed planes + per-row scales, and the dequantizing
    per-shard select merges across processes (sharded_query local_quant)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from picovdb_tpu.ops.quant import quantize_rows_i4, unpack_i4
    from picovdb_tpu.parallel.sharded_query import make_sharded_topk

    v4, scales = quantize_rows_i4(jnp.asarray(full))
    v4_np, sc_np = np.asarray(v4), np.asarray(scales)
    # exactly what the kernel scores: dequantized nibbles * per-row scale
    deq = np.asarray(unpack_i4(v4)).astype(np.float32) * sc_np[:, None]

    row_sh = NamedSharding(mesh, P("shard", None))
    vec_sh = NamedSharding(mesh, P("shard"))
    v4_g = jax.device_put(v4_np, row_sh)
    sc_g = jax.device_put(sc_np, vec_sh)
    mask_g = jax.device_put(np.ones(full.shape[0], dtype=bool), vec_sh)

    fn = make_sharded_topk(mesh, "shard", 5, storage_i4=True)
    vals, idx = fn(q_rep, v4_g, sc_g, mask_g)
    vals = np.asarray(jax.device_get(vals))
    idx = np.asarray(jax.device_get(idx))
    s, want = _oracle_topk(qn, deq, 5)
    ovals = np.take_along_axis(s, want, axis=1)
    np.testing.assert_allclose(vals, ovals, rtol=1e-5, atol=1e-6)
    for qi in range(qn.shape[0]):  # tie-robust id check via scores
        np.testing.assert_allclose(
            s[qi][idx[qi]], ovals[qi], rtol=1e-5, atol=1e-6
        )


def run_ivf(mesh, full, qn):
    """ShardedIVF across processes: build, full-probe search, then one
    incremental update() epoch (append 2, delete 1) re-served exactly."""
    from picovdb_tpu.parallel.ivf_mesh import ShardedIVF

    n, dim = full.shape
    k = 5
    ivf = ShardedIVF.build(
        full, np.ones(n, dtype=bool), mesh, nlist=8, dim=dim
    )
    vals, slots = ivf.search(qn, k, ef=10**6, dev=None)  # full probe
    s, want = _oracle_topk(qn, full, k)
    ovals = np.take_along_axis(s, want, axis=1)
    np.testing.assert_allclose(vals, ovals, rtol=1e-5, atol=1e-6)
    for qi in range(qn.shape[0]):
        np.testing.assert_allclose(
            s[qi][slots[qi]], ovals[qi], rtol=1e-5, atol=1e-6
        )

    # incremental epoch: same deterministic mutation set in every process
    rng = np.random.default_rng(11)
    new = rng.standard_normal((2, dim)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    changed = np.array([0, n, n + 1])
    rows = np.vstack([np.zeros((1, dim), np.float32), new])
    ok = ivf.update(changed, rows, np.array([False, True, True]))
    assert ok, "incremental update refused on the 2-process mesh"

    corpus = np.vstack([full, new])
    live = np.ones(n + 2, dtype=bool)
    live[0] = False
    vals2, slots2 = ivf.search(qn, k, ef=10**6, dev=None)
    s2, want2 = _oracle_topk(qn, corpus, k, live=live)
    ovals2 = np.take_along_axis(s2, want2, axis=1)
    np.testing.assert_allclose(vals2, ovals2, rtol=1e-5, atol=1e-6)
    for qi in range(qn.shape[0]):
        np.testing.assert_allclose(
            s2[qi][slots2[qi]], ovals2[qi], rtol=1e-5, atol=1e-6
        )
    # the new rows are findable point queries
    v3, s3 = ivf.search(new[:1], 1, ef=10**6, dev=None)
    assert s3[0, 0] == n, s3


def run_ivf8(mesh, vectors, full, qn):
    """int8-only ShardedIVF across processes: per-shard int8 postings
    select, the exact rescore gathers each process's slice of the sharded
    f32 corpus by LOCAL slot id, then one in-place update() epoch
    (frozen-scale requantize) re-serves exactly."""
    import types

    from picovdb_tpu.parallel.ivf_mesh import ShardedIVF

    n, dim = full.shape
    k = 5
    ivf = ShardedIVF.build(
        full, np.ones(n, dtype=bool), mesh, nlist=8, dim=dim,
        i8_only=True, corpus_cap=n,
    )
    assert ivf.vectors is None and ivf.vectors_i8c is not None
    dev = types.SimpleNamespace(cap=n, vectors=vectors, vstore_scale=None)
    vals, slots = ivf.search(qn, k, ef=10**6, dev=dev)  # full probe
    s, want = _oracle_topk(qn, full, k)
    ovals = np.take_along_axis(s, want, axis=1)
    # int8 selection + exact rescore: returned scores must be the true
    # corpus cosines of the returned ids (tie/selection-noise robust)
    for qi in range(qn.shape[0]):
        np.testing.assert_allclose(
            s[qi][slots[qi]], vals[qi], rtol=1e-5, atol=1e-6
        )
        assert slots[qi][0] == want[qi][0], (slots[qi], want[qi])

    # in-place epoch: delete row 0, replace row 1 (same corpus slot) —
    # the frozen-scale requantize path, identical in every process
    rng = np.random.default_rng(11)
    new = rng.standard_normal((1, dim)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    new *= 0.8  # stay inside the build-time dynamic range
    ok = ivf.update(
        np.array([0, 1]),
        np.vstack([np.zeros((1, dim), np.float32), new]),
        np.array([False, True]),
    )
    assert ok, "i8-only incremental update refused on the 2-process mesh"
    assert ivf.last_update_clip_fraction <= 0.05

    from jax.sharding import NamedSharding, PartitionSpec as P

    full2 = full.copy()
    full2[1] = new[0]
    local_rows = n // jax.process_count()
    start = jax.process_index() * local_rows
    vectors2 = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("shard", None)),
        full2[start : start + local_rows],
    )
    dev2 = types.SimpleNamespace(cap=n, vectors=vectors2, vstore_scale=None)
    live = np.ones(n, dtype=bool)
    live[0] = False
    vals2, slots2 = ivf.search(qn, k, ef=10**6, dev=dev2)
    s2, want2 = _oracle_topk(qn, full2, k, live=live)
    for qi in range(qn.shape[0]):
        np.testing.assert_allclose(
            s2[qi][slots2[qi]], vals2[qi], rtol=1e-5, atol=1e-6
        )
        assert 0 not in slots2[qi]
    v3, s3 = ivf.search(full2[1:2], 1, ef=10**6, dev=dev2)
    assert s3[0, 0] == 1, s3


def run_engine(mesh, base, dim, full):
    """Engine-level multi-process serving (VERDICT r4 #4): a PicoVectorDB
    constructed in EVERY process over the global mesh — each reads only
    its own checkpoint shard — with queries, upserts, deletes, batched
    vector getters, a distributed re-save, and a reload, all verified
    against the host oracle. Every process issues the identical call
    sequence (the SPMD contract)."""
    from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR

    n = full.shape[0]
    db = PicoVectorDB(embedding_dim=dim, storage_file=base, mesh=mesh)
    assert db._host_lazy and db._host_vectors is None
    assert db.count() == n

    ids = db.get_all()
    id_list = [r[K_ID] for r in ids]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    s, want = _oracle_topk(qn, full, 5)
    res = db.query(q, top_k=5)
    for qi in range(3):
        got_ids = [h[K_ID] for h in res[qi]]
        assert got_ids == [id_list[j] for j in want[qi]], (qi, got_ids)
        np.testing.assert_allclose(
            [h["_metrics_"] for h in res[qi]],
            np.take_along_axis(s, want, axis=1)[qi], rtol=1e-5, atol=1e-5,
        )

    # batched vector getter: replicated-output gather, every process
    # reads the dequantized rows locally
    got_vec = db.get([id_list[1]], include_vector=True)[0][K_VECTOR]
    np.testing.assert_allclose(got_vec, full[1], rtol=1e-5, atol=1e-6)

    # identical mutation set in every process: update 1, delete 1,
    # append 4 (keeps the re-saved row count divisible by the device
    # count for the reload below)
    rng2 = np.random.default_rng(11)
    newv = rng2.standard_normal((5, dim)).astype(np.float32)
    newv /= np.linalg.norm(newv, axis=1, keepdims=True)
    db.upsert(
        [{K_ID: id_list[2], K_VECTOR: newv[0]}]
        + [{K_ID: f"mh_new{j}", K_VECTOR: newv[1 + j]} for j in range(4)]
    )
    db.delete([id_list[5]])

    corpus = np.vstack([full, newv[1:5]])
    corpus[2] = newv[0]
    live = np.ones(n + 4, dtype=bool)
    live[5] = False
    ids2 = id_list + [f"mh_new{j}" for j in range(4)]
    s2, want2 = _oracle_topk(qn, corpus, 5, live=live)
    res2 = db.query(q, top_k=5)
    for qi in range(3):
        got_ids = [h[K_ID] for h in res2[qi]]
        assert got_ids == [ids2[j] for j in want2[qi]], (qi, got_ids)
    assert db.query(newv[1], top_k=1)[0][K_ID] == "mh_new0"
    assert all(
        h[K_ID] != id_list[5] for h in db.query(full[5], top_k=10)
    )

    # distributed re-save (one shard file per process) + reload
    db.save()
    db2 = PicoVectorDB(embedding_dim=dim, storage_file=base, mesh=mesh)
    assert db2.count() == n + 4 - 1
    res3 = db2.query(q, top_k=5)
    for qi in range(3):
        assert [h[K_ID] for h in res3[qi]] == [
            ids2[j] for j in want2[qi]
        ], qi


def run_engine_i8(mesh, base, dim, full):
    """Multi-process engine with int8 DEVICE storage: the distributed
    save must write DEQUANTIZED f32 shards (r5 review finding: the slice
    program used to cast the raw int8 code plane to f32 — codes saved as
    vectors, double-quantized on reload)."""
    from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR
    from picovdb_tpu import persistence

    n = full.shape[0]
    qbase = base + "_i8"
    db = PicoVectorDB(embedding_dim=dim, storage_file=qbase, mesh=mesh,
                      storage_dtype="int8")
    db.upsert(
        [{K_ID: f"q{i}", K_VECTOR: full[i]} for i in range(n)]
    )
    assert db.count() == n
    db.save()  # distributed: one f32 shard per process

    shards = persistence.find_shards(qbase)
    assert len(shards) == jax.process_count(), shards
    saved = np.concatenate([np.load(p) for p in shards])
    assert saved.shape == (n, dim), saved.shape
    fulln = full / np.linalg.norm(full, axis=1, keepdims=True)
    # int8 per-row symmetric quantization: ~0.4% per component — codes
    # written raw would be off by the ~127x scale factor instead
    np.testing.assert_allclose(saved, fulln, rtol=0, atol=2e-2)

    # reload the f32 shards as a plain mesh store (the distributed load
    # path is f32/bf16); ranking must agree with the int8 twin — it
    # would not if the shards held raw codes
    db2 = PicoVectorDB(embedding_dim=dim, storage_file=qbase, mesh=mesh)
    assert db2.count() == n
    # self-queries: the stored row itself must be top-1 in both engines
    # (a codes-as-vectors checkpoint would rank arbitrary rows first);
    # exact rank parity is not required — int8 storage ranks by
    # dequantized scores, which may flip near-ties at dim=16
    for i in (0, 3, n - 1):
        assert db.query(full[i], top_k=1)[0][K_ID] == f"q{i}"
        assert db2.query(full[i], top_k=1)[0][K_ID] == f"q{i}"


def main() -> int:
    pid, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    base, dim = sys.argv[4], int(sys.argv[5])
    mode = sys.argv[6] if len(sys.argv) > 6 else "exact"

    from picovdb_tpu.parallel.multihost import (
        init_distributed,
        load_host_shard,
        pod_mesh,
    )
    from picovdb_tpu import persistence

    init_distributed(f"127.0.0.1:{port}", num_processes=nprocs,
                     process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()
    mesh = pod_mesh(dp=1)

    if mode in ("engine", "engine_odd"):
        full = np.concatenate(
            [np.load(p) for p in persistence.find_shards(base)]
        )
        run_engine(mesh, base, dim, full)
        print(f"MH OK pid={pid} mode={mode}", flush=True)
        return 0

    if mode == "engine_i8":
        full = np.concatenate(
            [np.load(p) for p in persistence.find_shards(base)]
        )
        run_engine_i8(mesh, base, dim, full)
        print(f"MH OK pid={pid} mode={mode}", flush=True)
        return 0

    vectors = load_host_shard(base, dim, mesh)
    n = vectors.shape[0]

    from jax.sharding import NamedSharding, PartitionSpec as P

    local_rows = n // nprocs
    mask = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("shard")), np.ones(local_rows, dtype=bool)
    )

    # oracle from the full matrix (host-side, reading every shard)
    full = np.concatenate(
        [np.load(p) for p in persistence.find_shards(base)]
    )
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    q_rep = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P()), q
    )

    if mode == "exact":
        run_exact(mesh, vectors, mask, full, qn, q_rep)
    elif mode == "i4":
        run_i4(mesh, full, qn, q_rep)
    elif mode == "ivf":
        run_ivf(mesh, full, qn)
    elif mode == "ivf8":
        run_ivf8(mesh, vectors, full, qn)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print(f"MH OK pid={pid} mode={mode}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
