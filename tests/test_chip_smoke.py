"""chip_smoke.py on the CPU: its phases at tiny sizes, its oracle and
checks, and its refusal to run without a GPU."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

DIM = 64


@pytest.fixture(scope="module")
def data():
    centers = cs.make_centers(32, DIM, 0)
    return cs.make_mixture(4096, centers, 1), cs.make_mixture(96, centers, 2)


def test_mixture_is_seeded_unit_and_clustered(data):
    rows, _ = data
    centers = cs.make_centers(32, DIM, 0)
    again = cs.make_mixture(4096, centers, 1, workers=3, chunk=1000)
    np.testing.assert_allclose(np.linalg.norm(rows, axis=1), 1.0, atol=1e-5)
    # chunking differs, so rows differ; the cluster geometry does not
    best = (again @ centers.T).max(axis=1)
    assert again.shape == rows.shape and np.median(best) > 0.9


def test_oracle_matches_brute_force(data):
    rows, q = data
    mask = np.arange(len(rows)) % 3 != 0
    ids, sc = cs.oracle_topk(rows, q, mask=mask, chunk=700)
    s = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float64) \
        @ rows.astype(np.float64).T
    s[:, ~mask] = -np.inf
    want = np.sort(s, axis=1)[:, ::-1][:, : cs.K + 1]
    np.testing.assert_allclose(sc, want, atol=1e-6)
    assert mask[ids].all()


def test_check_exact_rejects_a_wrong_answer(data):
    rows, q = data
    oracle = cs.oracle_topk(rows, q[:4])
    hits = [[{"_id_": str(i), "_metrics_": float(s)}
             for i, s in zip(oracle[0][r, :cs.K], oracle[1][r, :cs.K])]
            for r in range(4)]
    cs.check_exact("right", hits, oracle)
    hits[0][0] = {"_id_": str(oracle[0][0, cs.K]), "_metrics_": 0.0}
    with pytest.raises(cs.SmokeFailure):
        cs.check_exact("wrong", hits, oracle)


def test_phases_f32_and_ivf(tmp_path, data):
    rows, q = data
    out = cs.phase_f32(str(tmp_path), rows.copy(), q, index="ivf")
    db, live = out.pop("db"), out.pop("live")
    assert "ivf" in out["strategies"] and "xla_topk" in out["strategies"]
    assert live.sum() == len(rows) - len(rows) // 100
    res = cs.phase_ivf(db, rows, q, live, n_exact=8, n_recall=32)
    assert res["identical"] == 8 and res["recall"] >= cs.IVF_RECALL


def test_phases_quant_and_ingest(tmp_path, data):
    rows, q = data
    out = cs.phase_quant(str(tmp_path), rows, q)
    assert out["int8"]["strategies"] == ["i8stor_xla"]
    assert out["int4"]["strategies"] == ["i4stor_xla"]
    out = cs.phase_ingest(str(tmp_path), 4096, DIM, 32, 3)
    assert out["strategies"] == ["xla_topk"]


def test_phase_four_on_virtual_devices(tmp_path, data):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 (virtual) devices")
    rows, q = data
    out = cs.phase_four(str(tmp_path), rows.copy(), q, jax.devices()[:4],
                        index="ivf")
    assert len(out["bytes_in_use"]) == 4
    assert {"sharded_scan", "sharded_scan_i8stor"} <= set(out["strategies"])


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        cs.main([])
    assert e.value.code != 0
    captured = capsys.readouterr()
    assert "no GPU" in captured.err and captured.out == ""


def test_script_alone_exits_nonzero(tmp_path):
    """Copied into a directory without the package, the script fails
    without printing a result."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
