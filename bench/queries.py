"""Sequential single-query latency over a random corpus.

Counterpart of the reference's bench/queries.py (100 sequential 1024-d
queries, top-10, better_than=0.1; README.md:70/82 numbers). Each call pays
a host->device and a device->host transfer; see bench/batch_queries.py and
../bench.py for throughput modes.
"""

import argparse
import time

import numpy as np

import set_path  # noqa: F401
from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--queries", type=int, default=100)
    p.add_argument("--topk", type=int, default=10)
    args = p.parse_args()

    rng = np.random.default_rng(0)
    data = rng.normal(size=(args.n, args.dim)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=args.dim, storage_file="bench_queries_db")
    db.upsert([{K_ID: str(i), K_VECTOR: data[i]} for i in range(args.n)])

    qs = rng.normal(size=(args.queries, args.dim)).astype(np.float32)
    db.query(qs[0], top_k=args.topk)  # warm: compile + device sync

    lat = []
    t0 = time.perf_counter()
    for i in range(args.queries):
        t = time.perf_counter()
        res = db.query(qs[i], top_k=args.topk, better_than=0.1)
        lat.append(time.perf_counter() - t)
    total = time.perf_counter() - t0
    lat.sort()
    print(f"{args.queries} single queries over {args.n}: {total:.3f} s total, "
          f"p50 {lat[len(lat)//2]*1000:.2f} ms, p95 {lat[int(len(lat)*0.95)]*1000:.2f} ms")


if __name__ == "__main__":
    main()
