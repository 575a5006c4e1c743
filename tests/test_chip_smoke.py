"""chip_smoke.py's phases at tiny sizes on the CPU, and its refusals.

On the GPU the script runs the same phase functions at full size; here they
run on small generated matrices so the control flow, the oracle checks and
the serve phase's compile count are exercised without a card."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from benchmarks.matrices import fem_like, powerlaw_like, stencil_3d

REPO = Path(__file__).resolve().parent.parent


def _tiny_mats():
    return {
        "cant_like": lambda: fem_like(400, dofs=3, neighbors=5, seed=2),
        "cant_like_seed3": lambda: fem_like(400, dofs=3, neighbors=5, seed=3),
        "webbase1M_like": lambda: powerlaw_like(3000, avg_degree=3, seed=19),
        "laplace3d_64": lambda: stencil_3d(8, seed=12),
        "pdb1HYS_like": lambda: fem_like(300, dofs=9, neighbors=4, seed=4),
        "cli_4704": lambda: fem_like(200, dofs=3, neighbors=4, seed=5),
        "ldoor_like": lambda: fem_like(3000, dofs=3, neighbors=4,
                                       bandwidth=100, seed=7),
    }


def test_full_size_matrices_cover_every_phase():
    assert set(chip_smoke.full_size_matrices()) == set(_tiny_mats())


def test_one_card_phases_tiny(capsys):
    recs = chip_smoke.one_card_phases(_tiny_mats(), ns=(16, 40), n_mid=24,
                                      n_large=32)
    phases = [r["phase"] for r in recs]
    assert phases == ["fem", "fem", "scattered", "stencil", "slab", "edge",
                      "serve", "serve", "cli", "precise", "large"]
    for r in recs:
        if r["phase"] != "cli":
            assert r["gate"] == "pass" and r["ulp"] <= 16, r
    precise = recs[phases.index("precise")]
    assert precise["ulp"] <= chip_smoke.PRECISE_ULP_BOUND
    serve = [r for r in recs if r["phase"] == "serve"]
    assert serve[0]["bucket_new"] and not serve[1]["bucket_new"]
    assert serve[1]["compiles"] == 0
    # the CPU test platform runs the plain-XLA ELL engine
    assert recs[phases.index("scattered")]["engine"] == "ell"


def test_four_card_phases_tiny():
    """The --four path on four of the test mesh's virtual CPU devices."""
    recs = chip_smoke.four_card_phases(_tiny_mats(), n=16)
    assert [r["phase"] for r in recs] == ["four_row", "four_k", "four_ell",
                                          "four_hybrid"]
    for r in recs:
        assert r["gate"] == "pass"
        assert r["ulp_vs_one_card"] <= 2 * chip_smoke.ULP_BOUND


def test_check_rejects_a_wrong_result():
    coo = fem_like(200, dofs=3, neighbors=4, seed=1)
    b, c = chip_smoke.operands(coo, 8)
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm_exact

    exact = golden_spmm_exact(CSRMatrix.from_coo(coo), b, chip_smoke.ALPHA,
                              chip_smoke.BETA, c).astype(np.float32)
    ok = chip_smoke.check(coo, b, c, exact, bound=16, device_oracle=False)
    assert ok["gate"] == "pass"
    wrong = exact.copy()
    wrong[:50] += 1.0
    with pytest.raises(AssertionError, match="gate"):
        chip_smoke.check(coo, b, c, wrong, bound=16, device_oracle=False)


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert "{" not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script fails and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    with pytest.raises(json.JSONDecodeError):
        json.loads(last[0])
