"""End-to-end smoke test of picovdb on an NVIDIA GPU.

Drives the public `PicoVectorDB` API once at a real size and checks every
answer against a NumPy float64 oracle that shares no code with the store.
One process, one card:

    python chip_smoke.py            # phases f32, ivf, quant, ingest
    python chip_smoke.py --four     # only the four-card sharded path

Data is a seeded clustered mixture: unit centers plus a noise vector of norm
0.35 (per-dimension sigma 0.35/sqrt(dim)), renormalized, so rows of one
cluster have cosine ~0.89 with each other. Phases (default 1M x 1024, top-10):

  f32     float32 store through `upsert_columnar` with index="auto"; the IVF
          tier must be built and serve Q=1; Q=1, Q=64 and Q=2048 through
          `query` / `query_batched`; a 10%-selective `where` filter, an
          `ids` filter; delete 1% and query; save, reload, query.
  ivf     at full nprobe the IVF ids equal the exact route's; recall@10 at
          the default ef over Q=1 dispatches must reach 0.9.
  quant   the same rows stored as bfloat16, int8 and int4 (exact index, so
          the storage route itself serves), host rescore included.
  ingest  `ingest_device` of a corpus made with `jax.random`, then queries.

Tolerances: float32, int8 and int4 (host rescore): the ids equal the
oracle's, except where the oracle's k-th and (k+1)-th scores lie within 1e-5,
and every score is within 1e-5 (f32 dots at HIGHEST precision accumulate
1024 terms in float32). bfloat16 storage: recall@10 >= 0.99 and scores within
4e-3 (the documented storage trade).

The script exits nonzero, printing no result, when JAX finds no GPU. Its
last line is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

N_ONE = 2**20          # corpus rows on one card
N_FOUR = 8 * 2**20     # corpus rows over four cards (--four)
DIM = 1024
N_QUERIES = 2048
N_CENTERS = 4096
K = 10
EXACT_TOL = 1e-5
BF16_TOL = 4e-3
BF16_RECALL = 0.99
IVF_RECALL = 0.9
NOISE = 0.35
ROUTES = {
    "xla_topk", "xla_approx", "i8stor_xla", "i4stor_xla",
    "sharded_scan", "sharded_scan_i8stor", "sharded_scan_i4stor",
    "ivf", "ivf_i8",
}


class SmokeFailure(AssertionError):
    """A check of the smoke test did not hold."""


def log(msg: str) -> None:
    print(msg, flush=True)


def require_gpu():
    """The JAX devices, or exit 2 when they are not GPUs."""
    import jax

    try:
        devices = jax.devices()
    except RuntimeError as e:  # a GPU platform was requested but is absent
        devices, reason = [], str(e).splitlines()[0]
    else:
        reason = f"JAX platform is {devices[0].platform!r}"
    if not devices or devices[0].platform != "gpu":
        print(f"{os.path.basename(sys.argv[0])}: no GPU found ({reason}); "
              "this runs only on an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    return devices


# ---------------------------------------------------------------- data


def make_centers(n_centers: int, dim: int, seed: int) -> np.ndarray:
    c = np.random.default_rng(seed).standard_normal(
        (n_centers, dim), dtype=np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


def make_mixture(n: int, centers: np.ndarray, seed: int,
                 chunk: int = 65_536, workers: int = 8) -> np.ndarray:
    """(n, dim) unit rows around `centers`; each chunk draws from its own
    seeded generator, so the rows do not depend on the thread count."""
    dim = centers.shape[1]
    sigma = NOISE / float(np.sqrt(dim))
    out = np.empty((n, dim), dtype=np.float32)
    starts = list(range(0, n, chunk))
    seqs = np.random.SeedSequence(seed).spawn(len(starts))

    def fill(j):
        s = starts[j]
        e = min(n, s + chunk)
        rng = np.random.default_rng(seqs[j])
        c = rng.integers(0, centers.shape[0], size=e - s)
        block = rng.standard_normal((e - s, dim), dtype=np.float32)
        block *= sigma
        block += centers[c]
        block /= np.linalg.norm(block, axis=1, keepdims=True)
        out[s:e] = block

    with ThreadPoolExecutor(workers) as pool:
        list(pool.map(fill, range(len(starts))))
    return out


# -------------------------------------------------------------- oracle


def oracle_topk(data: np.ndarray, queries: np.ndarray, k: int = K,
                mask=None, extra: int = 32, chunk: int = 131_072):
    """Exact top-(k+1) ids and float64 cosine scores of `queries` over the
    rows of `data` where `mask` holds.

    Candidates come from a float32 BLAS pass (top k+extra per query), then
    every candidate is rescored in float64 and sorted; f32 rounding (~1e-6)
    cannot push a true top-(k+1) row below k+extra candidates.
    """
    q64 = queries.astype(np.float64)
    q64 /= np.linalg.norm(q64, axis=1, keepdims=True)
    q32 = q64.astype(np.float32)
    m = k + 1 + extra
    nq = q32.shape[0]
    best_s = np.full((nq, 0), -np.inf, np.float32)
    best_i = np.zeros((nq, 0), np.int64)
    for s in range(0, data.shape[0], chunk):
        e = min(data.shape[0], s + chunk)
        sc = q32 @ data[s:e].T
        if mask is not None:
            sc[:, ~mask[s:e]] = -np.inf
        take = min(m, e - s)
        part = np.argpartition(-sc, take - 1, axis=1)[:, :take]
        cand_s = np.concatenate(
            [best_s, np.take_along_axis(sc, part, axis=1)], axis=1)
        cand_i = np.concatenate([best_i, part + s], axis=1)
        keep = np.argsort(-cand_s, axis=1, kind="stable")[:, :m]
        best_s = np.take_along_axis(cand_s, keep, axis=1)
        best_i = np.take_along_axis(cand_i, keep, axis=1)
    rows = data[best_i.ravel()].astype(np.float64).reshape(nq, m, -1)
    rows /= np.linalg.norm(rows, axis=2, keepdims=True)
    exact = np.einsum("qd,qmd->qm", q64, rows)
    exact[~np.isfinite(best_s)] = -np.inf
    order = np.argsort(-exact, axis=1, kind="stable")[:, : k + 1]
    return (np.take_along_axis(best_i, order, axis=1),
            np.take_along_axis(exact, order, axis=1))


def hits_to_arrays(hits, k: int = K):
    """Engine results (lists of dicts) -> (Q, k) int ids (-1 missing) and
    (Q, k) scores (-inf missing)."""
    from picovdb_tpu import K_ID, K_METRICS

    if hits and isinstance(hits[0], dict):
        hits = [hits]
    ids = np.full((len(hits), k), -1, np.int64)
    sc = np.full((len(hits), k), -np.inf, np.float64)
    for i, row in enumerate(hits):
        for j, h in enumerate(row[:k]):
            ids[i, j] = int(h[K_ID])
            sc[i, j] = h[K_METRICS]
    return ids, sc


def check_exact(name: str, hits, oracle, tol: float = EXACT_TOL) -> dict:
    """ids equal the oracle's (unless its k-th and (k+1)-th scores lie
    within 1e-5) and every score is within `tol`."""
    ids, sc = hits_to_arrays(hits)
    o_ids, o_sc = oracle
    o_ids, o_sc = o_ids[: len(ids)], o_sc[: len(ids)]
    ties = bad = 0
    for i in range(len(ids)):
        if o_sc.shape[1] > K and o_sc[i, K - 1] - o_sc[i, K] < EXACT_TOL:
            ties += 1
        elif set(ids[i].tolist()) != set(o_ids[i, :K].tolist()):
            bad += 1
    err = float(np.max(np.abs(sc - o_sc[:, :K])))
    log(f"  check {name}: Q={len(ids)} id mismatches {bad} "
        f"(boundary ties skipped {ties}), max |score err| {err:.3g} "
        f"(tol {tol:g})")
    if bad or not err <= tol:
        raise SmokeFailure(f"{name}: {bad} id mismatches, score err {err}")
    return {"q": len(ids), "mismatches": bad, "ties": ties, "max_err": err}


def recall_at_k(hits, oracle) -> float:
    ids, _ = hits_to_arrays(hits)
    o_ids = oracle[0][: len(ids), :K]
    return float(np.mean([
        len(set(ids[i].tolist()) & set(o_ids[i].tolist())) / K
        for i in range(len(ids))
    ]))


def check_recall(name: str, hits, oracle, floor: float,
                 tol: float = None) -> dict:
    r = recall_at_k(hits, oracle)
    msg = f"  check {name}: Q={len(hits)} recall@{K} {r:.4f} (floor {floor})"
    out = {"q": len(hits), "recall": r}
    if tol is not None:
        _, sc = hits_to_arrays(hits)
        err = float(np.max(np.abs(sc - oracle[1][: len(sc), :K])))
        msg += f", max |score err| {err:.3g} (tol {tol:g})"
        out["max_err"] = err
        if not err <= tol:
            log(msg)
            raise SmokeFailure(f"{name}: score err {err}")
    log(msg)
    if r < floor:
        raise SmokeFailure(f"{name}: recall {r} < {floor}")
    return out


def check_route(db, allowed=ROUTES) -> str:
    """The last dispatch's strategy, which must be a surviving XLA route
    (optionally walked in row blocks)."""
    s = db.last_query_debug()["strategy"]
    base = s[: -len("_blocked")] if s and s.endswith("_blocked") else s
    log(f"    strategy {s}")
    if base not in allowed:
        raise SmokeFailure(f"unexpected dispatch strategy {s!r}")
    return s


class Timer:
    """First-call (compile + run) and warm latencies of one query shape."""

    def __init__(self):
        self.rows = {}

    def run(self, label: str, fn, warm: int = 3):
        t0 = time.perf_counter()
        out = fn()
        first = time.perf_counter() - t0
        times = []
        for _ in range(warm):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times)) if times else float("nan")
        self.rows[label] = {"first_s": first, "warm_ms": med * 1e3,
                            "compile_s": max(0.0, first - med)}
        log(f"  time {label}: first call {first:.3f} s (compile ~"
            f"{max(0.0, first - med):.3f} s), warm median {med * 1e3:.3f} ms")
        return out


# --------------------------------------------------------------- phases


def phase_f32(workdir: str, data: np.ndarray, queries: np.ndarray,
              big_ef: int = 1 << 20, index: str = "auto") -> dict:
    """float32 store, index="auto": IVF for Q=1, exact for batches.
    (`index="ivf"` builds the tier below the auto size threshold.)"""
    from picovdb_tpu import PicoVectorDB

    n, dim = data.shape
    t_phase = time.perf_counter()
    path = os.path.join(workdir, "f32")
    ids = [str(i) for i in range(n)]
    meta = [{"g": i % 10} for i in range(n)]
    db = PicoVectorDB(embedding_dim=dim, storage_file=path, index=index)
    t0 = time.perf_counter()
    db.upsert_columnar(data, ids=ids, metadata=meta)
    log(f"  upsert_columnar {n} x {dim}: {time.perf_counter() - t0:.2f} s")
    timer = Timer()
    q1, q64 = queries[:1], queries[:64]
    oracle = oracle_topk(data, queries)
    checks = {}
    routes = []

    hit = timer.run("Q=1 query_one (default ef)",
                    lambda: db.query_one(q1[0], top_k=K))
    dbg = db.last_query_debug()
    if not dbg["ann_active"] or not dbg["strategy"].startswith("ivf"):
        raise SmokeFailure(f"IVF tier did not serve Q=1: {dbg}")
    routes.append(check_route(db))
    log(f"  IVF tier served Q=1: {dbg['strategy']}, operating point "
        f"{dbg['ann_operating_point']}")
    checks["q1_default_ef_recall"] = recall_at_k([hit], oracle)
    hit = timer.run("Q=1 query_one (full nprobe)",
                    lambda: db.query_one(q1[0], top_k=K, ef_search=big_ef))
    routes.append(check_route(db))
    checks["q1_full_probe"] = check_exact("f32 Q=1 full probe", [hit],
                                          oracle)
    for qn, qq in (("64", q64), ("2048", queries)):
        hits = timer.run(f"Q={qn} query", lambda: db.query(qq, top_k=K))
        routes.append(check_route(db))
        checks[f"q{qn}_query"] = check_exact(f"f32 Q={qn} query", hits,
                                             oracle)
        hits = timer.run(f"Q={qn} query_batched",
                         lambda: db.query_batched(qq, top_k=K))
        routes.append(check_route(db))
        checks[f"q{qn}_batched"] = check_exact(f"f32 Q={qn} query_batched",
                                               hits, oracle)

    where_mask = (np.arange(n) % 10) == 3
    hits = timer.run("Q=64 where (10%)",
                     lambda: db.query(q64, top_k=K, where={"g": 3}))
    routes.append(check_route(db))
    checks["where"] = check_exact(
        "f32 where g=3", hits, oracle_topk(data, q64, mask=where_mask))
    rng = np.random.default_rng(7)
    sel = np.sort(rng.choice(n, size=min(n, 4096), replace=False))
    ids_mask = np.zeros(n, bool)
    ids_mask[sel] = True
    sel_ids = [ids[i] for i in sel]
    hits = timer.run("Q=64 ids filter",
                     lambda: db.query(q64, top_k=K, ids=sel_ids))
    routes.append(check_route(db))
    checks["ids"] = check_exact(
        "f32 ids filter", hits, oracle_topk(data, q64, mask=ids_mask))

    gone = np.sort(rng.choice(n, size=max(1, n // 100), replace=False))
    t0 = time.perf_counter()
    db.delete([ids[i] for i in gone])
    live = np.ones(n, bool)
    live[gone] = False
    hits = db.query(q64, top_k=K)
    log(f"  delete {gone.size} rows + first query: "
        f"{time.perf_counter() - t0:.2f} s")
    routes.append(check_route(db))
    live_oracle = oracle_topk(data, q64, mask=live)
    checks["after_delete"] = check_exact("f32 after delete", hits,
                                         live_oracle)

    t0 = time.perf_counter()
    db.save()
    del db
    gc.collect()
    db = PicoVectorDB(embedding_dim=dim, storage_file=path, index=index)
    hits = db.query(q64, top_k=K)
    log(f"  save + reload + first query: {time.perf_counter() - t0:.2f} s")
    routes.append(check_route(db))
    checks["reloaded"] = check_exact("f32 reloaded", hits, live_oracle)
    hit = db.query_one(q64[0], top_k=K, ef_search=big_ef)
    routes.append(check_route(db))
    checks["reloaded_q1"] = check_exact("f32 reloaded Q=1 full probe",
                                        [hit], live_oracle)
    wall = time.perf_counter() - t_phase
    log(f"  phase f32 wall {wall:.1f} s; strategies {sorted(set(routes))}")
    return {"db": db, "live": live, "wall_s": wall, "times": timer.rows,
            "checks": checks, "strategies": sorted(set(routes))}


def phase_ivf(db, data: np.ndarray, queries: np.ndarray, live=None,
              n_exact: int = 32, n_recall: int = 256,
              big_ef: int = 1 << 20) -> dict:
    """Full-nprobe IVF equals the exact route; default-ef recall >= 0.9.
    Every query is its own Q=1 dispatch (the honest per-query recall)."""
    t_phase = time.perf_counter()
    qs = queries[: max(n_exact, n_recall)]
    oracle = oracle_topk(data, qs, mask=live)
    timer = Timer()
    strategies = set()
    full = []
    for i in range(n_exact):
        full.append(db.query_one(qs[i], top_k=K, ef_search=big_ef))
        strategies.add(check_route(db))
    # a filter keeps the ANN tier out: the exact route serves the batch
    exact = db.query(qs[:n_exact], top_k=K, where=lambda d: True)
    strategies.add(check_route(db))
    same = sum(
        [h["_id_"] for h in a] == [h["_id_"] for h in b]
        for a, b in zip(full, exact)
    )
    log(f"  check ivf full nprobe vs exact route: {same}/{n_exact} "
        f"identical id lists")
    check_exact("ivf full nprobe vs oracle", full, oracle)
    if same != n_exact:
        raise SmokeFailure(f"full-probe IVF differs from exact on "
                           f"{n_exact - same} queries")
    timer.run("Q=1 default ef", lambda: db.query_one(qs[0], top_k=K))
    hits = [db.query_one(qs[i], top_k=K) for i in range(n_recall)]
    strategies.add(check_route(db))
    if not any(s.startswith("ivf") for s in strategies):
        raise SmokeFailure("the IVF tier served no query")
    rec = check_recall("ivf default ef", hits, oracle, IVF_RECALL)
    wall = time.perf_counter() - t_phase
    log(f"  phase ivf wall {wall:.1f} s; strategies {sorted(strategies)}")
    return {"wall_s": wall, "times": timer.rows, "identical": same,
            "recall": rec["recall"], "strategies": sorted(strategies)}


def phase_quant(workdir: str, data: np.ndarray, queries: np.ndarray) -> dict:
    """bfloat16 / int8 / int4 storage through the storage routes (exact
    index), the host rescore included (Q <= 128)."""
    from picovdb_tpu import PicoVectorDB

    n, dim = data.shape
    t_phase = time.perf_counter()
    q64 = queries[:64]
    oracle = oracle_topk(data, q64)
    ids = [str(i) for i in range(n)]
    out = {}
    for sd in ("bfloat16", "int8", "int4"):
        timer = Timer()
        t0 = time.perf_counter()
        db = PicoVectorDB(embedding_dim=dim,
                          storage_file=os.path.join(workdir, sd),
                          storage_dtype=sd, index="exact")
        db.upsert_columnar(data, ids=ids)
        log(f"  {sd}: upsert_columnar {time.perf_counter() - t0:.2f} s")
        strategies = set()
        h1 = timer.run(f"{sd} Q=1", lambda: db.query_one(q64[0], top_k=K))
        strategies.add(check_route(db))
        h64 = timer.run(f"{sd} Q=64", lambda: db.query(q64, top_k=K))
        strategies.add(check_route(db))
        if db.last_query_debug()["rescore"] != "host":
            raise SmokeFailure(f"{sd}: host rescore did not apply")
        if sd == "bfloat16":
            checks = [check_recall(f"{sd} Q=1", [h1], oracle, BF16_RECALL,
                                   BF16_TOL),
                      check_recall(f"{sd} Q=64", h64, oracle, BF16_RECALL,
                                   BF16_TOL)]
        else:
            checks = [check_exact(f"{sd} Q=1", [h1], oracle),
                      check_exact(f"{sd} Q=64", h64, oracle)]
        log(f"  {sd} strategies {sorted(strategies)}")
        out[sd] = {"times": timer.rows, "checks": checks,
                   "strategies": sorted(strategies)}
        del db
        gc.collect()
    wall = time.perf_counter() - t_phase
    log(f"  phase quant wall {wall:.1f} s")
    out["wall_s"] = wall
    return out


def phase_ingest(workdir: str, n: int, dim: int, n_centers: int, seed: int,
                 n_queries: int = 64, big_ef: int = 1 << 20) -> dict:
    """`ingest_device` of a corpus generated on the device."""
    import jax
    import jax.numpy as jnp

    from picovdb_tpu import PicoVectorDB

    t_phase = time.perf_counter()
    kc, kl, kn = jax.random.split(jax.random.PRNGKey(seed), 3)
    centers = jax.random.normal(kc, (n_centers, dim), jnp.float32)
    centers = centers / jnp.linalg.norm(centers, axis=1, keepdims=True)
    labels = jax.random.randint(kl, (n,), 0, n_centers)
    noise = jax.random.normal(kn, (n, dim), jnp.float32)
    rows = centers[labels] + noise * (NOISE / float(np.sqrt(dim)))
    rows = rows / jnp.linalg.norm(rows, axis=1, keepdims=True)
    host = np.asarray(rows)  # the oracle's copy; ingest may donate `rows`
    queries = make_mixture(n_queries, np.asarray(centers), seed + 1)
    oracle = oracle_topk(host, queries)
    db = PicoVectorDB(embedding_dim=dim,
                      storage_file=os.path.join(workdir, "ingest"))
    t0 = time.perf_counter()
    db.ingest_device(rows, ids=[str(i) for i in range(n)])
    del rows
    log(f"  ingest_device {n} x {dim}: {time.perf_counter() - t0:.2f} s")
    timer = Timer()
    strategies = set()
    hits = timer.run("Q=64 query", lambda: db.query(queries, top_k=K))
    strategies.add(check_route(db))
    checks = [check_exact("ingest Q=64", hits, oracle)]
    hit = timer.run("Q=1 full nprobe",
                    lambda: db.query_one(queries[0], top_k=K,
                                         ef_search=big_ef))
    strategies.add(check_route(db))
    checks.append(check_exact("ingest Q=1", [hit], oracle))
    del db
    gc.collect()
    wall = time.perf_counter() - t_phase
    log(f"  phase ingest wall {wall:.1f} s; strategies {sorted(strategies)}")
    return {"wall_s": wall, "times": timer.rows, "checks": checks,
            "strategies": sorted(strategies)}


def phase_four(workdir: str, data: np.ndarray, queries: np.ndarray,
               devices, big_ef: int = 1 << 20, index: str = "auto") -> dict:
    """Row-sharded bfloat16 and int8 stores over a 4-way mesh: sharded
    exact, sharded IVF, per-card residency. (`index="ivf"` builds the tier
    below the auto size threshold.)"""
    from picovdb_tpu import PicoVectorDB
    from picovdb_tpu.parallel import make_mesh

    n, dim = data.shape
    t_phase = time.perf_counter()
    mesh = make_mesh(devices=devices)
    ids = [str(i) for i in range(n)]
    q64 = queries[:64]
    timer = Timer()
    strategies = set()
    out = {}

    t0 = time.perf_counter()
    db = PicoVectorDB(embedding_dim=dim, mesh=mesh, index=index,
                      storage_dtype="bfloat16",
                      storage_file=os.path.join(workdir, "mesh_bf16"))
    db.upsert_columnar(data, ids=ids, copy=False)  # normalizes `data`
    oracle = oracle_topk(data, q64)
    h64 = timer.run("bf16 sharded Q=64", lambda: db.query(q64, top_k=K))
    strategies.add(check_route(db))
    log(f"  bf16 store + first query: {time.perf_counter() - t0:.1f} s")
    per_card = [int((d.memory_stats() or {}).get("bytes_in_use", 0))
                for d in devices]
    log("  bytes_in_use per card: " + ", ".join(
        f"{d.id}: {b / 2**30:.2f} GiB" for d, b in zip(devices, per_card)))
    if min(per_card) < 0.5 * max(per_card):
        raise SmokeFailure(f"rows did not spread over the cards: {per_card}")
    out["bytes_in_use"] = per_card
    out["bf16_exact"] = check_recall("bf16 sharded Q=64", h64, oracle,
                                     BF16_RECALL, BF16_TOL)
    h1 = timer.run("bf16 sharded IVF Q=1 default ef",
                   lambda: db.query_one(q64[0], top_k=K))
    dbg = db.last_query_debug()
    strategies.add(check_route(db))
    if not dbg["strategy"].startswith("ivf"):
        raise SmokeFailure(f"sharded IVF did not serve Q=1: {dbg}")
    full = [db.query_one(q64[i], top_k=K, ef_search=big_ef)
            for i in range(16)]
    strategies.add(check_route(db))
    exact = db.query(q64[:16], top_k=K, where=lambda d: True)
    strategies.add(check_route(db))
    same = sum([h["_id_"] for h in a] == [h["_id_"] for h in b]
               for a, b in zip(full, exact))
    log(f"  check sharded IVF full nprobe vs sharded exact: {same}/16 "
        f"identical id lists")
    if same != 16:
        raise SmokeFailure("sharded IVF at full nprobe differs from exact")
    hits = [h1] + [db.query_one(q64[i], top_k=K) for i in range(1, 64)]
    out["ivf_recall"] = check_recall("sharded ivf default ef", hits, oracle,
                                     IVF_RECALL)["recall"]
    del db
    gc.collect()

    t0 = time.perf_counter()
    db = PicoVectorDB(embedding_dim=dim, mesh=mesh, index="exact",
                      storage_dtype="int8",
                      storage_file=os.path.join(workdir, "mesh_i8"))
    db.upsert_columnar(data, ids=ids, copy=False)
    h64 = timer.run("int8 sharded Q=64", lambda: db.query(q64, top_k=K))
    strategies.add(check_route(db))
    log(f"  int8 store + first query: {time.perf_counter() - t0:.1f} s")
    out["int8_exact"] = check_exact("int8 sharded Q=64 (host rescore)", h64,
                                    oracle)
    del db
    gc.collect()
    wall = time.perf_counter() - t_phase
    log(f"  phase four wall {wall:.1f} s; strategies {sorted(strategies)}")
    out.update(wall_s=wall, times=timer.rows, strategies=sorted(strategies))
    return out


# ----------------------------------------------------------------- main


def card_lines() -> list:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded path")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    devices = require_gpu()
    import jax

    n = N_FOUR if args.four else N_ONE
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    used = devices[:4] if args.four else devices[:1]
    log(f"device: platform {devices[0].platform}, kind "
        f"{devices[0].device_kind}, count {len(devices)} (using "
        f"{len(used)})")
    for line in card_lines():
        log(line)
    log(f"jax {jax.__version__}; corpus {n} x {DIM}, "
        f"{N_CENTERS} centers, noise norm {NOISE}, top-{K}")

    t0 = time.perf_counter()
    centers = make_centers(N_CENTERS, DIM, args.seed)
    data = make_mixture(n, centers, args.seed + 1,
                        workers=min(32, os.cpu_count() or 8))
    queries = make_mixture(N_QUERIES, centers, args.seed + 2)
    log(f"data: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(dir=os.getenv("TMPDIR")) as workdir:
        if args.four:
            log("phase four")
            phase_four(workdir, data, queries, used)
        else:
            log("phase f32")
            f32 = phase_f32(workdir, data, queries)
            db, live = f32.pop("db"), f32.pop("live")
            log("phase ivf")
            phase_ivf(db, data, queries, live)
            del db
            gc.collect()
            log("phase quant")
            phase_quant(workdir, data, queries)
            del data
            gc.collect()
            log("phase ingest")
            phase_ingest(workdir, n, DIM, N_CENTERS, args.seed + 3)
    d = used[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(used),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
