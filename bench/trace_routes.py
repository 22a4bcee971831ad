"""Time and trace the query routes on one GPU at 1M x 1024, top-10.

For the float32 exact route and the IVF probe at Q=1 and Q=2048, the int8
storage route at Q=2048, and the exact route's dense form against its
row-blocked form, this script measures device time (host clock around
`block_until_ready`, median of repeats) and takes one `jax.profiler` trace
per route. Each trace is reduced to the device operations that took the most
time (summed event durations on the GPU planes, with their HLO op names) and
the device busy share of the window.

It then splits a Q=64 `PicoVectorDB.query` on bfloat16 and int8 storage
(the host rescore path) into its parts: the device dispatches, the host
rescore, the saturation test and the escalated re-dispatch, with the
`rescore_escalations` counter and one trace of the whole call.

    python bench/trace_routes.py [--seed 0]

Prints one line per measurement. It needs a GPU and exits 2 without one.
"""

from __future__ import annotations

import argparse
import collections
import glob
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402  (data generator, device check)

K = 10


def median_ms(fn, reps: int) -> float:
    """Median wall time of fn() in ms; fn returns device arrays that are
    waited on inside the timed region. One untimed warm call first."""
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def device_op_totals(trace_dir: str, top: int = 8) -> dict:
    """Reduce one profiler trace: per device operation (kernel name + HLO
    op), the summed device duration and count; the device busy share of the
    traced window (union of event intervals over window length)."""
    import jax

    path = glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                  "*.xplane.pb"))[0]
    data = jax.profiler.ProfileData.from_file(path)
    totals: dict = {}
    spans = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                hlo = stats.get("hlo_op", "")
                key = (ev.name, str(hlo))
                tot, cnt = totals.get(key, (0.0, 0))
                totals[key] = (tot + ev.duration_ns, cnt + 1)
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    window = 0.0
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
        window = max(window, max(e for _, e in spans) - spans[0][0])
    ops = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "ops": [{"kernel": k[0][:120], "hlo_op": k[1], "total_us":
                 v[0] / 1e3, "count": v[1]} for k, v in ops],
        "device_busy_share": busy / window if window else None,
        "window_us": window / 1e3,
    }


def trace(label: str, fn, out: dict, iters: int = 3) -> None:
    import jax

    jax.block_until_ready(fn())
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(iters):
                jax.block_until_ready(fn())
        red = device_op_totals(d)
    out[label] = red
    busy = red["device_busy_share"]
    print(f"trace {label}: {iters} calls, device busy share "
          f"{busy if busy is None else round(busy, 4)} of "
          f"{red['window_us']:.1f} us", flush=True)
    for op in red["ops"]:
        print(f"    {op['total_us'] / iters:10.1f} us/call x{op['count']}"
              f"  {op['hlo_op']:<28} {op['kernel']}", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    n, dim = chip_smoke.N_ONE, chip_smoke.DIM

    devices = chip_smoke.require_gpu()
    import jax

    from picovdb_tpu import PicoVectorDB
    from picovdb_tpu.ops.exact import make_exact_topk

    for line in chip_smoke.card_lines():
        print(line, flush=True)
    print(f"device: {devices[0].platform} {devices[0].device_kind}, "
          f"corpus {n} x {dim}", flush=True)
    centers = chip_smoke.make_centers(chip_smoke.N_CENTERS, dim, args.seed)
    data = chip_smoke.make_mixture(n, centers, args.seed + 1,
                                   workers=min(32, os.cpu_count() or 8))
    qhost = chip_smoke.make_mixture(2048, centers, args.seed + 2)
    result = {"times_ms": {}, "traces": {}}
    times = result["times_ms"]

    with tempfile.TemporaryDirectory() as work:
        db = PicoVectorDB(embedding_dim=dim, index="ivf",
                          storage_file=os.path.join(work, "f32"))
        db.upsert_columnar(data, ids=[str(i) for i in range(n)])
        db.query_one(qhost[0], top_k=K)  # sync + IVF build
        dev, ivf = db._dev, db._ivf
        q1 = jax.device_put(qhost[:1])
        q2k = jax.device_put(qhost)

        def exact(q, block=None):
            fn = make_exact_topk(K, None, block=block)
            return lambda: fn(q, dev.vectors, dev.active)

        def probe(q):
            return lambda: ivf.search_async(q, K, 32, dev)[:2]

        block = 1 << 17
        for qn, q, reps in (("1", q1, 20), ("2048", q2k, 5)):
            for rep in range(2):  # dense, blocked, blocked, dense
                order = ("dense", "blocked") if rep == 0 else \
                    ("blocked", "dense")
                for form in order:
                    f = exact(q, None if form == "dense" else block)
                    key = f"exact_{form}_q{qn}"
                    t = median_ms(f, reps)
                    times.setdefault(key, []).append(t)
                    print(f"time {key} (block {block} rows if blocked): "
                          f"{t:.3f} ms", flush=True)
            key = f"ivf_q{qn}"
            times[key] = [median_ms(probe(q), reps)]
            print(f"time {key} (ef 32): {times[key][0]:.3f} ms", flush=True)
            trace(f"exact_q{qn}", exact(q), result["traces"])
            trace(f"ivf_q{qn}", probe(q), result["traces"])
        del db, dev, ivf

        db8 = PicoVectorDB(embedding_dim=dim, index="exact",
                           storage_dtype="int8",
                           storage_file=os.path.join(work, "i8"))
        db8.upsert_columnar(data, ids=[str(i) for i in range(n)])
        db8.query_one(qhost[0], top_k=K)

        def int8_route():
            return db8._dev.query_async(q2k, K, None)[:2]

        times["int8_q2048"] = [median_ms(int8_route, 5)]
        print(f"time int8_q2048: {times['int8_q2048'][0]:.3f} ms "
              f"({db8._dev.last_strategy})", flush=True)
        trace("int8_q2048", int8_route, result["traces"])
        del db8

        for sd in ("bfloat16", "int8"):
            db = PicoVectorDB(embedding_dim=dim, index="exact",
                              storage_dtype=sd,
                              storage_file=os.path.join(work, sd))
            db.upsert_columnar(data, ids=[str(i) for i in range(n)])
            rescore_split(db, sd, qhost[:64], result["traces"])
            del db
    return 0


def rescore_split(db, label: str, q, traces: dict, reps: int = 5) -> None:
    """Where a Q=64 `db.query` with the host rescore spends its time: each
    engine step is wrapped in a host-clock timer for `reps` warm calls and
    keyed by the (Q, k) it worked on, so the escalated re-dispatch and its
    rescore show apart from the first ones."""
    spent = collections.defaultdict(float)

    def wrap(name):
        inner = getattr(db, name)

        def timed(*a, **kw):
            t0 = time.perf_counter()
            out = inner(*a, **kw)
            if name == "_dispatch_query":
                name_k = f"{name}(Q={len(a[0])}, k={a[1]})"
            elif name == "_host_rescore":
                name_k = "{}(Q={}, k={})".format(name, *np.shape(a[1]))
            else:
                name_k = name
            spent[name_k] += time.perf_counter() - t0
            return out
        setattr(db, name, timed)

    db.query(q, top_k=K)  # compile both dispatch widths
    for name in ("_dispatch_query", "_host_rescore", "_rescore_saturated"):
        wrap(name)
    esc0 = db.stats()["rescore_escalations"]
    t0 = time.perf_counter()
    for _ in range(reps):
        db.query(q, top_k=K)
    total = (time.perf_counter() - t0) / reps * 1e3
    esc = (db.stats()["rescore_escalations"] - esc0) / reps
    print(f"rescore {label} Q={len(q)}: query {total:.3f} ms per call, "
          f"escalated queries per call {esc:g}, strategy "
          f"{db.last_query_debug()['strategy']}", flush=True)
    for k, v in spent.items():
        print(f"    {v / reps * 1e3:10.3f} ms/call  {k}", flush=True)
    trace(f"rescore_{label}_q{len(q)}", lambda: db.query(q, top_k=K), traces,
          iters=1)


if __name__ == "__main__":
    sys.exit(main())
