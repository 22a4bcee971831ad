"""Smoke test for the 10M north-star harness at toy scale.

`bench/northstar_10m.py` is the scale artifact for BASELINE.md's second
north star (10M x 1024 over a device mesh): columnar ingest -> sharded
persistence -> reload -> row-sharded mesh serving -> oracle assertion.
This runs the same script end-to-end at 16k rows so the full pipeline
(not just its pieces) stays covered by the suite; the script configures
its own virtual 8-device CPU mesh, so it runs as a subprocess.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_northstar_pipeline_smoke(tmp_path):
    out = tmp_path / "northstar_smoke.json"
    env = dict(os.environ)
    # a clean env: the script must set up its own platform/mesh
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(REPO, "bench", "northstar_10m.py"),
            "--rows", "16384", "--dim", "16", "--shards", "8",
            "--queries", "16", "--out", str(out),
        ],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=900,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(out.read_text())
    assert res["rows"] == 16384
    assert res["shard_files"] == 8
    assert res["recall_vs_oracle"] == 1.0, res
    assert res["strategy"].startswith("sharded")
