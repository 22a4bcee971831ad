"""Writer-starvation stress: measured writer waits under reader pressure.

Round-2 review weak item 7: the RWLock reproduces the reference's
no-writer-priority semantics (picovdb/pico_vdb.py:1019-1063), and this
framework's readers additionally hold the read lock through a device-mirror
currency check, widening the starvation window. This script produces the
number: writer acquisition latency under a saturated reader pool, for both
the default (reference-parity) lock and the opt-in writer-priority mode
(`writer_priority=True` / PICOVDB_WRITER_PRIORITY=1).

Two reader loads:
  - "serving" readers: back-to-back queries with a 2 ms gap (realistic);
  - "spin" readers: zero-gap queries (adversarial — with no writer priority
    this can starve the writer unboundedly, which is the reference's
    documented semantics, not a bug).

Writes lock_stress.json (see --out).

Usage: python lock_stress.py [--n 20000] [--dim 64] [--readers 4]
                             [--writes 10] [--deadline 30]
"""

import argparse
import json
import os
import threading
import time

import numpy as np

import set_path  # noqa: F401

from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR


def run_cell(n, dim, readers, writes, deadline, gap_s, writer_priority, rng):
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        db = PicoVectorDB(
            embedding_dim=dim,
            storage_file=os.path.join(td, "stress"),
            writer_priority=writer_priority,
        )
        vecs = rng.normal(size=(n, dim)).astype(np.float32)
        db.upsert_columnar(vecs.copy(), ids=[f"v{i}" for i in range(n)])
        db.query(vecs[0], top_k=4)  # warm the compile outside timing

        stop = threading.Event()
        errors = []

        def reader():
            i = 0
            while not stop.is_set():
                try:
                    db.query(vecs[i % n], top_k=4)
                except Exception as e:  # pragma: no cover
                    errors.append(repr(e))
                    return
                i += 1
                if gap_s:
                    time.sleep(gap_s)

        threads = [threading.Thread(target=reader) for _ in range(readers)]
        for t in threads:
            t.start()
        time.sleep(0.5)  # steady state

        waits = []
        deadline_hit = False

        def writer():
            for j in range(writes):
                t0 = time.perf_counter()
                db.upsert([{K_ID: f"new{j}", K_VECTOR: vecs[j % n]}])
                waits.append(time.perf_counter() - t0)

        tw = threading.Thread(target=writer)
        t_start = time.perf_counter()
        tw.start()
        tw.join(timeout=deadline)
        completed_at_deadline = len(waits)
        if tw.is_alive():
            deadline_hit = True
        stop.set()
        tw.join(timeout=60)
        for t in threads:
            t.join(timeout=60)
        wall = time.perf_counter() - t_start
        ws = sorted(waits)
        return {
            "writer_priority": writer_priority,
            "reader_gap_ms": gap_s * 1000,
            "readers": readers,
            "writes_requested": writes,
            "writes_completed_before_deadline": completed_at_deadline,
            "deadline_s": deadline,
            "starved_past_deadline": deadline_hit,
            "wall_s": round(wall, 3),
            "writer_wait_ms": {
                "p50": round(ws[len(ws) // 2] * 1000, 2) if ws else None,
                "max": round(ws[-1] * 1000, 2) if ws else None,
            },
            "errors": errors[:3],
        }


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=20_000)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--readers", type=int, default=4)
    p.add_argument("--writes", type=int, default=10)
    p.add_argument("--deadline", type=float, default=30.0)
    p.add_argument("--out", default="lock_stress.json")
    args = p.parse_args()

    rng = np.random.default_rng(7)
    cells = []
    for gap_s in (0.002, 0.0):
        for wp in (False, True):
            cell = run_cell(args.n, args.dim, args.readers, args.writes,
                            args.deadline, gap_s, wp, rng)
            print(json.dumps(cell))
            cells.append(cell)

    out = {
        "scenario": f"{args.n}x{args.dim}d, {args.readers} readers, "
                    f"{args.writes} single-item upserts",
        "cells": cells,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
