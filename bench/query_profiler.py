"""Scenario-matrix query profiler with CSV/JSON export.

Counterpart of the reference's bench/numpy_query_profiler.py (C25 in
SURVEY.md §2): sweeps db sizes x batch sizes across filter scenarios
(baseline / where 50% / where 10% / ids 10% / ids 1% / better_than /
combined) and reports mean/p50/p95 latency and ops/sec per cell.

Usage:
  python bench/query_profiler.py --db-sizes 10000 100000 --dim 1024 \
      --num-queries 32 --batch-sizes 1 8 64 --top-k 10 \
      [--csv out.csv] [--json out.json]
"""

import argparse
import csv
import json
import statistics
import time

import numpy as np

import set_path  # noqa: F401
from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR


def scenario_generators(n):
    """Scenario name -> query kwargs (mirrors the reference's scenarios)."""
    return {
        "baseline": lambda: {},
        "where_50pct": lambda: {"where": {"bucket2": 0}},
        "where_10pct": lambda: {"where": {"bucket10": 0}},
        "ids_10pct": lambda: {"ids": [str(i) for i in range(0, n, 10)]},
        "ids_1pct": lambda: {"ids": [str(i) for i in range(0, n, 100)]},
        "better_than": lambda: {"better_than": 0.05},
        "combined": lambda: {
            "where": {"bucket10": 0},
            "better_than": 0.0,
        },
    }


def _make_store(n, dim, rng, gen):
    """Build the profiled store. `gen="device"` generates the corpus on the
    device and adopts it via ingest_device (no host generation or upload,
    the fast path at >=1M rows)."""
    metadata = [{"bucket2": i % 2, "bucket10": i % 10} for i in range(n)]
    ids = [str(i) for i in range(n)]
    db = PicoVectorDB(embedding_dim=dim, storage_file=f"profiler_db_{n}")
    if gen == "device":
        import jax
        import jax.numpy as jnp

        chunk = 131_072
        import functools

        @functools.partial(jax.jit, donate_argnums=(0,))
        def fill(buf, key, start):
            rows = jax.random.normal(key, (chunk, dim), dtype=jnp.float32)
            return jax.lax.dynamic_update_slice(buf, rows, (start, 0))

        buf = jnp.zeros((n, dim), dtype=jnp.float32)
        key = jax.random.PRNGKey(rng.integers(1 << 31))
        s = 0
        while s < n:
            key, sub = jax.random.split(key)
            if s + chunk <= n:
                buf = fill(buf, sub, s)
                s += chunk
            else:
                tail = jax.random.normal(sub, (n - s, dim), dtype=jnp.float32)
                buf = jax.lax.dynamic_update_slice(buf, tail, (s, 0))
                s = n
        db.ingest_device(buf, ids=ids, metadata=metadata)
    else:
        data = np.empty((n, dim), dtype=np.float32)
        for s in range(0, n, 131_072):
            e = min(n, s + 131_072)
            data[s:e] = rng.standard_normal((e - s, dim), dtype=np.float32)
        db.upsert_columnar(data, ids=ids, metadata=metadata, copy=False)
    return db


def run_suite(db_sizes, dim, num_queries, batch_sizes, top_k, seed=0,
              gen="host", pipeline=0):
    rng = np.random.default_rng(seed)
    rows = []
    for n in db_sizes:
        t0 = time.perf_counter()
        db = _make_store(n, dim, rng, gen)
        print(f"# store build ({gen}): {time.perf_counter()-t0:.1f} s",
              flush=True)
        queries = rng.standard_normal(
            (max(batch_sizes) * num_queries, dim), dtype=np.float32
        )
        db.query(queries[0], top_k=top_k)  # warm compile + sync
        for scenario, kwargs_fn in scenario_generators(n).items():
            kwargs = kwargs_fn()
            for bs in batch_sizes:
                # Per-(scenario, batch) warmup excluded from the stats:
                # each (Q-bucket, filter-shape) pair compiles its own XLA
                # specialization (1-40 s), and with it inside the timed
                # loop p95 described compilation, not serving (r2
                # artifacts showed p95 = 25x p50 on first-touch cells).
                db.query(
                    queries[0] if bs == 1 else queries[:bs],
                    top_k=top_k,
                    **kwargs,
                )
                lats = []
                for it in range(num_queries):
                    q = (
                        queries[it * bs]
                        if bs == 1
                        else queries[it * bs : (it + 1) * bs]
                    )
                    t0 = time.perf_counter()
                    db.query(q, top_k=top_k, **kwargs)
                    lats.append(time.perf_counter() - t0)
                lats_ms = [x * 1000 for x in lats]
                per_query = sum(lats) / (num_queries * bs)
                rows.append(
                    {
                        "db_size": n,
                        "dim": dim,
                        "scenario": scenario,
                        "batch_size": bs,
                        "mean_ms": statistics.mean(lats_ms),
                        "p50_ms": statistics.median(lats_ms),
                        "p95_ms": sorted(lats_ms)[int(len(lats_ms) * 0.95)],
                        "ops_per_sec": 1.0 / per_query,
                        "strategy": db._last_topk_strategy,
                        "k_eff": db._last_k_eff,
                    }
                )
                print(
                    f"n={n} {scenario:>12} bs={bs:>4}: "
                    f"mean {rows[-1]['mean_ms']:.2f} ms, "
                    f"p95 {rows[-1]['p95_ms']:.2f} ms, "
                    f"{rows[-1]['ops_per_sec']:.0f} q/s",
                    flush=True,
                )
            if pipeline:
                # Serving-mode number: `pipeline` back-to-back columnar
                # batches, one fetch wave — amortizes the per-call
                # round trip out of the measurement (same methodology as
                # bench.py). The filter mask uploads once
                # (device-side mask cache) like a production tenant filter.
                bs = max(batch_sizes)
                qb = [queries[i * bs:(i + 1) * bs] for i in range(2)]
                db.query_columnar(qb[0], top_k=top_k, **kwargs)  # warm
                best = float("inf")
                for _ in range(3):
                    t0 = time.perf_counter()
                    for i in range(pipeline):
                        db.query_columnar(qb[i % 2], top_k=top_k, **kwargs)
                    best = min(best, time.perf_counter() - t0)
                qps = pipeline * bs / best
                rows.append(
                    {
                        "db_size": n, "dim": dim,
                        "scenario": scenario + "+pipelined",
                        "batch_size": bs,
                        "mean_ms": best / pipeline * 1000,
                        "p50_ms": None, "p95_ms": None,
                        "ops_per_sec": qps,
                        "strategy": db._last_topk_strategy,
                        "k_eff": db._last_k_eff,
                    }
                )
                print(
                    f"n={n} {scenario:>12} bs={bs:>4} pipelined: "
                    f"{qps:.0f} q/s", flush=True,
                )
    return rows


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--db-sizes", type=int, nargs="+", default=[10_000])
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--num-queries", type=int, default=16)
    p.add_argument("--batch-sizes", type=int, nargs="+", default=[1, 16, 256])
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--gen", choices=["host", "device"], default="host",
                   help="device: on-device corpus generation + "
                        "ingest_device (the fast path at >=1M rows)")
    p.add_argument("--pipeline", type=int, default=0,
                   help="also record a serving-mode (pipelined columnar) "
                        "QPS per scenario at the largest batch size")
    p.add_argument("--csv")
    p.add_argument("--json")
    args = p.parse_args()

    rows = run_suite(
        args.db_sizes, args.dim, args.num_queries, args.batch_sizes,
        args.top_k, gen=args.gen, pipeline=args.pipeline,
    )
    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)


if __name__ == "__main__":
    main()
