"""10M x 1024-d north-star feasibility check (BASELINE.md) on a CPU mesh.

On a virtual 8-device CPU mesh this builds a real 10M-row store at reduced
dim through the production path — columnar ingest, sharded persistence
(`save(shards=8)`), reload, row-sharded mesh serving with the cross-device
top-k merge — and asserts exact-oracle correctness of the served results.
This exercises every control-plane and data-plane component the 10M x 1024
deployment needs; only the per-device sweep arithmetic is scaled down (the
real per-card sweep runs in `chip_smoke.py --four`).

Writes one JSON artifact (default northstar10m.json, see --out).

Usage:
  python bench/northstar_10m.py [--rows 10000000] [--dim 32] [--shards 8]
"""

import argparse
import contextlib
import json
import os
import sys
import time

import set_path  # noqa: F401  (source-checkout import path, like set_path.py)

# Virtual CPU mesh, forced the way tests/conftest.py does it: the ambient
# environment may preset an accelerator platform (or import jax at start),
# so both the env var and the live config must be overridden before any
# backend initializes.
os.environ["JAX_PLATFORMS"] = "cpu"
if "xla_force_host_platform_device_count" not in os.environ.get(
    "XLA_FLAGS", ""
):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
# XLA CPU's in-process collectives kill the program when the shard threads
# arrive at a rendezvous more than 40 s apart — on a 1-core host the 8
# serialized shard sweeps of a 10M-row store can exceed that legitimately.
if "collective_call_terminate" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] += (
        " --xla_cpu_collective_call_terminate_timeout_seconds=1200"
    )
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=10_000_000)
    p.add_argument("--dim", type=int, default=32)
    p.add_argument("--shards", type=int, default=8)
    p.add_argument("--topk", type=int, default=10)
    p.add_argument("--queries", type=int, default=64)
    p.add_argument("--storage-dtype", default=None,
                   help="device storage dtype (e.g. int8, a quarter of "
                        "the float32 bytes per row)")
    p.add_argument("--index", default="exact", choices=["exact", "ivf"])
    p.add_argument("--nlist", type=int, default=0,
                   help="IVF cluster count (0 = engine auto ~2*sqrt(N))")
    p.add_argument("--nprobe", type=int, default=0,
                   help="IVF probe width (0 = engine default; for a "
                        "correctness artifact on random data use a full "
                        "probe, --nprobe == --nlist)")
    p.add_argument("--recall-floor", type=float, default=0.0,
                   help="override the pass/fail recall floor (0 = "
                        "dtype-based default)")
    p.add_argument("--out", default="northstar10m.json")
    p.add_argument("--reuse", default="",
                   help="path prefix of an existing sharded store: skip "
                        "gen/ingest/save and serve straight from it "
                        "(ingest/save numbers carried from the build run "
                        "are then reported as 0)")
    args = p.parse_args()

    import jax

    from picovdb_tpu import PicoVectorDB
    from picovdb_tpu.parallel import make_mesh
    from picovdb_tpu import persistence

    assert len(jax.devices()) >= args.shards, jax.devices()
    mesh = make_mesh(n_shards=args.shards)

    import tempfile

    rng = np.random.default_rng(0)
    out = {"rows": args.rows, "dim": args.dim, "shards": args.shards,
           "storage_dtype": args.storage_dtype or "float32",
           "index": args.index}

    ctx = (
        tempfile.TemporaryDirectory()
        if not args.reuse
        else contextlib.nullcontext(os.path.dirname(args.reuse) or ".")
    )
    with ctx as tmp:
        path = f"{tmp}/northstar" if not args.reuse else args.reuse

        if args.reuse:
            shard_files = persistence.find_shards(path)
            assert len(shard_files) == args.shards, shard_files
            out["reused_store"] = True
            out["shard_files"] = len(shard_files)
            out["bytes_per_shard"] = os.path.getsize(shard_files[0])
            print(f"# reusing store {path} ({len(shard_files)} shards)",
                  file=sys.stderr)
        else:
            # ---- build: columnar ingest of 10M rows --------------------
            t0 = time.perf_counter()
            data = rng.standard_normal(
                (args.rows, args.dim), dtype=np.float32
            )
            gen_s = time.perf_counter() - t0
            db = PicoVectorDB(
                embedding_dim=args.dim, storage_file=path, mesh=mesh,
                index=args.index, storage_dtype=args.storage_dtype,
                ivf_nlist=args.nlist or None,
                ivf_nprobe=args.nprobe or None,
            )
            ids = [str(i) for i in range(args.rows)]
            t0 = time.perf_counter()
            db.upsert_columnar(data, ids=ids, copy=False)
            ingest_s = time.perf_counter() - t0
            out["ingest_s"] = round(ingest_s, 2)
            out["ingest_vec_per_s"] = round(args.rows / ingest_s, 0)
            print(f"# gen {gen_s:.1f} s; ingest {args.rows} rows in "
                  f"{ingest_s:.1f} s ({args.rows/ingest_s:.0f} vec/s)",
                  file=sys.stderr)

            # ---- sharded persistence ----------------------------------
            t0 = time.perf_counter()
            db.save(shards=args.shards)
            save_s = time.perf_counter() - t0
            shard_files = persistence.find_shards(path)
            assert len(shard_files) == args.shards, shard_files
            out["save_s"] = round(save_s, 2)
            out["shard_files"] = len(shard_files)
            out["bytes_per_shard"] = os.path.getsize(shard_files[0])
            print(f"# sharded save: {save_s:.1f} s, "
                  f"{len(shard_files)} files x "
                  f"{out['bytes_per_shard']/2**20:.0f} MiB", file=sys.stderr)
            del db

        # ---- reload through the sharded loader ------------------------
        t0 = time.perf_counter()
        db2 = PicoVectorDB(
            embedding_dim=args.dim, storage_file=path, mesh=mesh,
            index=args.index, storage_dtype=args.storage_dtype,
            ivf_nlist=args.nlist or None,
            ivf_nprobe=args.nprobe or None,
        )
        load_s = time.perf_counter() - t0
        assert db2.count() == args.rows  # count() doesn't force the lazy id map
        out["load_s"] = round(load_s, 2)
        print(f"# reload: {load_s:.1f} s", file=sys.stderr)

        # ---- serve + exact-oracle correctness -------------------------
        # Pre-touch every shard's corpus pages with local (collective-free)
        # reductions first: XLA CPU's in-process rendezvous terminates the
        # program when shards arrive at a collective more than 40 s apart,
        # and on a 1-core host the first sweep's page faults over GBs of
        # freshly-written corpus can exceed that window per shard.
        t0 = time.perf_counter()
        for sh in db2._dev.vectors.addressable_shards:
            float(np.asarray(sh.data.sum()))
        for sh in db2._dev.active.addressable_shards:
            float(np.asarray(sh.data.sum()))
        print(f"# page pre-touch: {time.perf_counter()-t0:.1f} s",
              file=sys.stderr)
        m = args.queries
        q = rng.standard_normal((m, args.dim), dtype=np.float32)
        db2.query_columnar(q[:1], top_k=args.topk)  # per-shard compile warm
        ids_col, scores_col = db2.query_columnar(q, top_k=args.topk)  # warm
        t0 = time.perf_counter()
        ids_col, scores_col = db2.query_columnar(q, top_k=args.topk)
        serve_s = time.perf_counter() - t0
        out["serve_batch_ms"] = round(serve_s * 1000, 1)
        out["serve_qps"] = round(m / serve_s, 1)
        assert db2._last_topk_strategy.startswith(("sharded", "ivf")), (
            db2._last_topk_strategy
        )
        out["strategy"] = db2._last_topk_strategy

        # oracle on a sample (f32 host matmul over the normalized corpus)
        qs = q[:8].astype(np.float32)
        qs /= np.linalg.norm(qs, axis=1, keepdims=True)
        dn = np.asarray(db2._host_vectors[: args.rows])
        chunk = 2_000_000
        best = np.full((8, args.topk), -np.inf, dtype=np.float32)
        best_i = np.zeros((8, args.topk), dtype=np.int64)
        for s in range(0, args.rows, chunk):
            sc = qs @ dn[s : s + chunk].T
            loc = np.argsort(-sc, axis=1)[:, : args.topk]
            cand_v = np.concatenate(
                [best, np.take_along_axis(sc, loc, axis=1)], axis=1
            )
            cand_i = np.concatenate([best_i, loc + s], axis=1)
            order = np.argsort(-cand_v, axis=1)[:, : args.topk]
            best = np.take_along_axis(cand_v, order, axis=1)
            best_i = np.take_along_axis(cand_i, order, axis=1)
        agree = np.mean(
            [
                len(
                    {int(x) for x in ids_col[i] if x is not None}
                    & set(best_i[i].tolist())
                )
                / args.topk
                for i in range(8)
            ]
        )
        out["recall_vs_oracle"] = round(float(agree), 5)
        print(f"# serve {m} queries: {serve_s*1000:.0f} ms "
              f"({out['serve_qps']} qps, {out['strategy']}); "
              f"recall@{args.topk} vs oracle = {agree:.4f}", file=sys.stderr)
        floor = args.recall_floor or (
            0.999 if args.storage_dtype != "int8" else 0.95
        )
        assert agree >= floor, agree

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
