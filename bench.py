"""Headline benchmark: batch query QPS at 100k x 1024-d, top-10, exact.

Reproduces the reference's batch-query workload (bench/batch_queries.py:
dim=1024, N=100,000 random vectors, top_k=10) against the full engine and
prints ONE JSON line:

    {"metric": ..., "value": QPS, "unit": "qps", "vs_baseline": x}

Baseline = 10,000 QPS, the reference's best published batch throughput
(FAISS HNSW batch mode on an M3: 1000 queries in 0.1 s, README.md:76 /
BASELINE.md) — and that is an approximate index, while every number here is
an exact scan (recall@10 verified against a float64 oracle below).

The headline is the serving contract: query embeddings device-resident (as
produced by an upstream on-device embedding model), results as (string-id,
score) columns. The reference's dict-per-hit contract and host-resident
queries are measured too and reported on stderr. The JSON line names the
device it ran on (platform, kind, count); without a GPU the script exits 2.

Usage: python bench.py [--n 100000] [--dim 1024] [--queries 8192]
                       [--topk 10] [--check]
"""

import argparse
import json
import sys
import time

import numpy as np


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--dim", type=int, default=1024)
    p.add_argument("--queries", type=int, default=32768)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=2048)
    p.add_argument("--recall-sample", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--storage-dtype", default=None,
                   help="device storage dtype (e.g. bfloat16)")
    p.add_argument("--scan-mode", default="auto",
                   choices=["auto", "approx", "xla"])
    p.add_argument("--insert-mode", default="columnar",
                   choices=["columnar", "dict"],
                   help="bulk-load API: columnar fast lane (default) or the "
                        "reference-style per-item dict path")
    p.add_argument("--check", action="store_true",
                   help="exit nonzero unless recall@10 >= 0.99")
    args = p.parse_args()

    import tempfile

    import jax

    from chip_smoke import require_gpu

    require_gpu()  # a measurement without the card is not one: exit 2

    from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR

    rng = np.random.default_rng(0)
    # float32 generation (no f64 intermediate scratch next to the timed
    # insert)
    data = rng.standard_normal((args.n, args.dim), dtype=np.float32)
    queries = rng.standard_normal((args.queries, args.dim), dtype=np.float32)

    with tempfile.TemporaryDirectory() as tmp:
        ids = [str(i) for i in range(args.n)]

        def one_insert(path):
            db = PicoVectorDB(
                embedding_dim=args.dim, storage_file=path, index="exact",
                storage_dtype=args.storage_dtype, scan_mode=args.scan_mode
            )
            t0 = time.perf_counter()
            if args.insert_mode == "columnar":
                # Bulk-load lane: one (n, dim) matrix + id column,
                # normalized in place, zero per-item Python work (vs the
                # reference's per-item loop, picovdb/pico_vdb.py:403-498).
                # data is adopted as backing storage; rows are
                # L2-normalized in place (direction-preserving, so the
                # oracle below is unaffected; the second pass re-normalizes
                # unit rows, same BLAS work).
                db.upsert_columnar(data, ids=ids, copy=False)
            else:
                db.upsert(
                    [{K_ID: ids[i], K_VECTOR: data[i]} for i in range(args.n)]
                )
            return db, time.perf_counter() - t0

        # Two passes, best-of reported: the first pays the page-fault tax
        # on freshly generated pages; the second measures the insert path
        # itself. Both are printed. One element per 4 KB
        # page is read immediately before each pass so the metric measures
        # the insert path, not whether the shared host evicted the test
        # data between passes.
        def touch():
            np.add.reduce(data.reshape(-1)[:: 1024])

        touch()
        _, cold_s = one_insert(f"{tmp}/bench_cold")
        touch()
        db, warm_s = one_insert(f"{tmp}/bench")
        insert_s = min(cold_s, warm_s)
        insert_vec_s = args.n / insert_s
        print(f"# insert {args.n}x{args.dim} ({args.insert_mode}): "
              f"cold {cold_s:.2f} s ({args.n/cold_s:.0f} vec/s), "
              f"warm {warm_s:.2f} s ({args.n/warm_s:.0f} vec/s)",
              file=sys.stderr)

        # ---- headline: serving mode (device-resident queries, columnar) ----
        q_dev = jax.device_put(queries)  # upstream embedder output stand-in
        # Two chunk sizes (bigger chunks halve the per-dispatch overhead);
        # the best arm and its size are reported.
        serving_elapsed, serving_bs = float("inf"), args.batch_size
        ids_col = scores_col = None
        for bs in {args.batch_size, 4096}:
            ic, sc = db.query_columnar(
                q_dev, top_k=args.topk, batch_size=bs
            )  # warm: compile + first device sync
            times = []
            for _ in range(args.iters):
                t0 = time.perf_counter()
                ic, sc = db.query_columnar(
                    q_dev, top_k=args.topk, batch_size=bs
                )
                times.append(time.perf_counter() - t0)
            # best-of-N: host-clock means pick up unrelated load spikes
            if min(times) < serving_elapsed:
                serving_elapsed, serving_bs = min(times), bs
                ids_col, scores_col = ic, sc
        serving_qps = args.queries / serving_elapsed
        print(f"# serving (device queries, columnar, chunk={serving_bs}): "
              f"{args.queries} queries "
              f"in {serving_elapsed*1000:.1f} ms -> {serving_qps:.0f} QPS",
              file=sys.stderr)

        # ---- device-side batch throughput, transport excluded -------------
        # The serving number above includes the result fetches. Chain M
        # full-batch dispatches back-to-back and fetch only the last
        # chunk's buffer:
        # device work serializes in queue order, so the M1->M2 slope is the
        # pure device time per batch (same methodology as the Q=1 slope).
        def chain(m):
            t0 = time.perf_counter()
            last = None
            for _ in range(m):
                vd, xd, nq, ke = db._dev.query_async(
                    q_dev[: args.batch_size], args.topk, None)
                last = db._dev.pack_results(vd, xd)
            np.asarray(last[:1, :1])
            return time.perf_counter() - t0

        chain(1)  # warm
        # Each arm is floored independently (min over repeats estimates the
        # noise-free time; differencing noisy paired samples can go
        # negative when the fetch jitter exceeds a few batches of device
        # work). The 1->17 spread puts 16 batches of device compute above
        # that jitter.
        lo = min(chain(1) for _ in range(5))
        hi = min(chain(17) for _ in range(5))
        dev_batch_s = (hi - lo) / 16
        if dev_batch_s <= 0:  # pathological host noise: report the
            dev_batch_s = hi / 17  # conservative per-chain mean instead
        device_qps = args.batch_size / dev_batch_s
        print(f"# device-side batch throughput (dispatch-chain slope, "
              f"fetch excluded): {args.batch_size} queries in "
              f"{dev_batch_s*1000:.1f} ms -> {device_qps:.0f} QPS",
              file=sys.stderr)

        # ---- reference contract: host queries -> dict-per-hit results ----
        # Served on the int16 fixed-point wire (the `auto` pick): half the
        # f32 upload at recall@10 = 1.0000.
        _wp = db._wire_encode(queries[:2], args.queries)
        wire_mb = _wp.nbytes / 2 * args.queries / 1e6
        e2e = float("inf")
        for _ in range(3):  # best-of: host-clock noise
            t0 = time.perf_counter()
            results = db.query_batched(
                queries, top_k=args.topk, batch_size=min(args.batch_size, 2048)
            )
            e2e = min(e2e, time.perf_counter() - t0)
        print(f"# e2e host->dicts (best of 3): "
              f"{args.queries} queries in {e2e*1000:.1f} ms "
              f"-> {args.queries/e2e:.0f} QPS "
              f"({wire_mb:.0f} MB {_wp.dtype} query upload included)",
              file=sys.stderr)

        # same dict-per-hit contract, device-resident queries (the query
        # upload removed — isolates device compute + result fetch + native
        # dict assembly)
        db.query_batched(q_dev[:args.batch_size], top_k=args.topk,
                         batch_size=args.batch_size)  # warm
        e2e_dev = float("inf")
        for _ in range(3):  # best-of: host assembly shares the host cores
            t0 = time.perf_counter()
            results_dev = db.query_batched(
                q_dev, top_k=args.topk, batch_size=args.batch_size
            )
            e2e_dev = min(e2e_dev, time.perf_counter() - t0)
        dict_dev_qps = args.queries / e2e_dev
        print(f"# device->dicts (reference contract, device queries): "
              f"{args.queries} queries in {e2e_dev*1000:.1f} ms -> "
              f"{dict_dev_qps:.0f} QPS", file=sys.stderr)
        del results_dev

        # ---- recall@topk against float64 exact oracle (sampled) ----
        m = args.recall_sample
        qn = queries[:m].astype(np.float64)
        qn /= np.linalg.norm(qn, axis=1, keepdims=True)
        dn = data.astype(np.float64)
        dn /= np.linalg.norm(dn, axis=1, keepdims=True)
        oracle = np.argsort(-(qn @ dn.T), axis=1)[:, : args.topk]
        got = [
            {int(x) for x in ids_col[i] if x is not None} for i in range(m)
        ]
        recall = float(
            np.mean(
                [len(got[i] & set(oracle[i].tolist())) / args.topk
                 for i in range(m)]
            )
        )
        del dn
        print(f"# recall@{args.topk} vs f64 oracle: {recall:.4f}",
              file=sys.stderr)
        agree = np.mean([
            set(map(int, (r[K_ID] for r in results[i]))) == got[i]
            for i in range(m)
        ])
        print(f"# dict-contract vs columnar agreement: {agree:.3f}",
              file=sys.stderr)

        # ---- single-query p50 (host clock, transfers included) ----
        lat = []
        for i in range(30):
            t0 = time.perf_counter()
            db.query(queries[i], top_k=args.topk)
            lat.append(time.perf_counter() - t0)
        p50 = sorted(lat)[len(lat) // 2]
        print(f"# single-query p50: {p50*1000:.2f} ms", file=sys.stderr)

        # ---- single-query latency, launches amortized --------------------
        # M independent Q=1 scans dispatched back-to-back, one final fetch
        # each, overlapped: elapsed/M is the per-query cost with the
        # per-call round trip amortized (the reference publishes
        # 0.4 ms/query, README.md:75).
        M = 64
        q_single = [
            jax.device_put(queries[i][None, :]) for i in range(8)
        ]  # device-resident, like embeddings from an upstream model
        dev_pending = [
            db._dev.query_async(q_single[i], args.topk, None)
            for i in range(2)  # warm both the jit cache and the pipe
        ]
        for v, ix, _, _ in dev_pending:
            np.asarray(v), np.asarray(ix)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            dev_pending = [
                db._dev.query_async(q_single[i % 8], args.topk, None)
                for i in range(M)
            ]
            for v, ix, _, _ in dev_pending:  # overlap the tiny result fetches
                v.copy_to_host_async(), ix.copy_to_host_async()
            for v, ix, _, _ in dev_pending:
                np.asarray(v), np.asarray(ix)
            best = min(best, time.perf_counter() - t0)
        amortized_ms = best * 1000 / M
        print(f"# single-query, {M} independent Q=1 launches amortized "
              f"(includes the per-launch dispatch floor): "
              f"{amortized_ms:.3f} ms", file=sys.stderr)

        # ---- device-side single-query latency: on-device loop slope ----
        # query_serial_loop scans M Q=1 queries serially inside ONE
        # program, each sweeping the full corpus through the route a Q=1
        # dispatch takes. The marginal cost per query — the slope of wall
        # time vs M — is the device-side serving latency with
        # launch/transport overhead cancelled exactly (it appears in both
        # terms).
        Ms = (256, 1024)
        loop_t = {}
        for m_loop in Ms:
            qm = queries[:m_loop]
            db.query_serial_loop(qm, args.topk)  # warm compile
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                db.query_serial_loop(qm, args.topk)
                best = min(best, time.perf_counter() - t0)
            loop_t[m_loop] = best
        device_ms = (loop_t[Ms[1]] - loop_t[Ms[0]]) / (Ms[1] - Ms[0]) * 1000
        print(f"# single-query device latency (slope of {Ms[0]}->{Ms[1]} "
              f"on-device serialized sweeps, {db._dev.last_strategy}): "
              f"{device_ms:.3f} ms", file=sys.stderr)
        # loop-vs-dispatch parity spot check on the first queries
        lv, li = db.query_serial_loop(queries[:8], args.topk)
        pv, pi, _, _ = db._dev.query_async(queries[:8], args.topk, None)
        if not np.array_equal(li, np.asarray(pi)[:8, : args.topk]):
            print("# WARNING: serial-loop ids diverge from dispatch path",
                  file=sys.stderr)

    baseline_qps = 10_000.0  # reference FAISS batch mode, README.md:76
    print(
        json.dumps(
            {
                "metric": f"serving_batch_qps_{args.n}x{args.dim}d_"
                          f"top{args.topk}_{args.scan_mode}_recall{recall:.3f}"
                          + (f"_{args.storage_dtype}" if args.storage_dtype else ""),
                "value": round(serving_qps, 1),
                "unit": "qps",
                "vs_baseline": round(serving_qps / baseline_qps, 2),
                "serving_chunk": serving_bs,
                "insert_vec_per_s": round(insert_vec_s, 0),
                "batch_device_qps": round(device_qps, 0),
                "e2e_host_dicts_qps": round(args.queries / e2e, 0),
                "query_wire": str(_wp.dtype),
                "query_wire_mode": db._query_wire,
                "dict_contract_device_qps": round(dict_dev_qps, 0),
                "single_query_device_ms": round(device_ms, 3),
                "single_query_launch_amortized_ms": round(amortized_ms, 3),
                "device": {
                    "platform": jax.devices()[0].platform,
                    "kind": jax.devices()[0].device_kind,
                    "count": len(jax.devices()),
                },
            }
        )
    )
    if args.check and recall < 0.99:
        print(f"# RECALL REGRESSION: {recall} < 0.99", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
