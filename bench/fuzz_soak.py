"""Extended-seed soak of the differential fuzzer (tests/test_fuzz_differential.py).

The in-suite fuzz pins seeds 0-2 per storage config; this runner drives
FRESH seeds across every config cell — including the mesh-int4 and
forced-IVF cells — so regressions that only surface under rarer operation
interleavings are caught before a release. CPU-only (the oracle model is
the host); run it detached:

    python bench/fuzz_soak.py --seeds 3:43 | tee fuzz_soak.log

Exit code 0 iff every cell passed. Each failure reproduces exactly via
its printed (seed, config) cell.
"""

import jax

jax.config.update("jax_platforms", "cpu")

import argparse
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

from test_fuzz_differential import (  # noqa: E402
    STORAGE_CASES,
    test_fuzz_engine_matches_numpy_model as run_fuzz,
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", default="3:23",
                    help="half-open seed range start:stop (suite owns 0-2)")
    ap.add_argument("--mesh-every", type=int, default=8,
                    help="run the mesh-int4 cell every Nth seed (CPU mesh "
                         "dispatch makes it ~4x a single-device cell)")
    args = ap.parse_args()
    lo, hi = (int(p) for p in args.seeds.split(":"))

    rng = np.random.default_rng(42)  # mirrors the suite fixture
    cells = failures = 0
    t0 = time.time()
    for seed in range(lo, hi):
        configs = [(sdt, tol, dict(extra)) for sdt, tol, extra in STORAGE_CASES]
        # forced-IVF quantized cells (suite: test_fuzz_i8only_ivf / _int4_ivf)
        os.environ["PICOVDB_IVF_I8"] = "1"
        configs += [
            ("int8", 1.2e-2, {"index": "ivf", "ivf_nlist": 8, "ivf_nprobe": 8}),
            ("int4", 1.2e-2, {"index": "ivf", "ivf_nlist": 8, "ivf_nprobe": 8}),
        ]
        if seed % args.mesh_every == 0:
            from picovdb_tpu.parallel import make_mesh

            configs.append(("int4", 1.2e-2, {"mesh": make_mesh()}))
        for sdt, tol, extra in configs:
            cells += 1
            label = f"seed={seed} sdt={sdt} extra={extra}"
            try:
                with tempfile.TemporaryDirectory() as td:
                    run_fuzz(Path(td), seed, rng, sdt, tol, extra)
                print(f"PASS {label}", flush=True)
            except Exception:
                failures += 1
                print(f"FAIL {label}\n{traceback.format_exc()}", flush=True)
    wall = time.time() - t0
    print(f"# soak: {cells} cells, {failures} failures, {wall:.0f} s",
          flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
