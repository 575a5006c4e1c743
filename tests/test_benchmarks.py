"""Benchmark suite generator + runner tests."""

import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmarks.matrices import fem_like, kkt_like, powerlaw_like, suite
from benchmarks.suite import run_one


def test_fem_like_structure():
    coo = fem_like(3000, dofs=3, neighbors=9, seed=1)
    assert coo.shape == (3000, 3000)
    assert coo.nnz > 3000
    # FEM stand-in should have decent 8x8 block fill
    from sextans_tpu.utils.autotune import block_counts

    nb = block_counts(coo, (8,))[8]
    fill = coo.nnz / (nb * 64)
    assert fill > 0.05


def test_kkt_like_banded_three_scales():
    coo = kkt_like(8000, seed=2)
    assert coo.shape == (8000, 8000)
    spread = np.abs(coo.rows.astype(np.int64) - coo.cols.astype(np.int64))
    assert np.median(spread) < 8000 // 2  # banded-ish, not uniform


def test_powerlaw_has_hubs():
    coo = powerlaw_like(5000, avg_degree=8, seed=3)
    indeg = np.bincount(coo.cols, minlength=5000)
    assert indeg.max() > 20 * max(1, int(np.median(indeg[indeg > 0])))


def test_suite_registry():
    s = suite("small")
    assert "cant_like" in s and "webgraph_like" in s
    full = suite("full")
    assert "ldoor_like" in full and "nlpkkt80_like" in full


def test_run_one_tiny():
    coo = fem_like(600, dofs=3, neighbors=5, bandwidth=60, seed=9)
    rec = run_one("tiny", coo, 16, backend="xla", use_autotune=True, rp_time=2)
    assert rec["verify"] == "pass"
    assert rec["gflops"] > 0
    assert rec["block_fill"] > 0


def test_race_includes_2d_reorder_candidates(monkeypatch):
    """Hub-heavy matrices add 2-D reordered blocked candidates to the
    measured race (round-3 scattered-class lever)."""
    import io
    import contextlib

    import numpy as np

    from benchmarks import suite as suite_mod
    from sextans_tpu.format.coo import COOMatrix

    rng = np.random.default_rng(0)
    m = 512
    pop = rng.zipf(1.6, size=m).astype(np.float64)
    pop /= pop.sum()
    rows = rng.integers(0, m, 4000).astype(np.int32)
    cols = rng.choice(m, 4000, p=pop).astype(np.int32)
    lin = rows.astype(np.int64) * m + cols
    _, keep = np.unique(lin, return_index=True)
    coo = COOMatrix((m, m), rows[keep], cols[keep],
                    np.ones(keep.size, np.float32))

    # neutralize the expensive timing: every candidate 'measures' instantly
    import sextans_tpu.utils.timing as timing_mod

    monkeypatch.setattr(
        timing_mod, "time_repeat",
        lambda plan, b, a, be, c, times=1, detail=False:
            (1e-3, {"method": "differential", "times": times})
            if detail else 1e-3)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rec = suite_mod.run_one(
            "hubtest", coo, 16, "xla", True, verify_gate=True, hybrid="off",
        )
    assert rec["verify"] == "pass"
    assert "2d-reorder candidates added" in err.getvalue()


def test_csr_take_rows_matches_naive():
    from benchmarks.suite import _csr_take_rows
    from sextans_tpu.format.csr import CSRMatrix

    coo = fem_like(800, dofs=3, neighbors=5, seed=21)
    csr = CSRMatrix.from_coo(coo)
    rows = np.array([0, 3, 3, 17, 799, 798, 400], dtype=np.int64)
    sub = _csr_take_rows(csr, rows)
    assert sub.shape == (rows.size, 800)
    dense = np.zeros(coo.shape, np.float32)
    dense[coo.rows, coo.cols] = coo.vals
    sub_dense = np.zeros(sub.shape, np.float32)
    for i in range(rows.size):
        lo, hi = sub.indptr[i], sub.indptr[i + 1]
        sub_dense[i, sub.indices[lo:hi]] = sub.vals[lo:hi]
    np.testing.assert_array_equal(sub_dense, dense[rows])


def test_verify_sample_blocks_deterministic_and_bounded():
    from benchmarks.suite import _verify_sample_blocks

    b1 = _verify_sample_blocks(525625)
    b2 = _verify_sample_blocks(525625)
    assert b1 == b2  # deterministic (seeded jitter)
    assert all(0 <= s < e <= 525625 for s, e in b1)
    starts = [s for s, _ in b1]
    assert starts == sorted(starts)
    # strata span the full M range, not just a prefix
    assert b1[0][0] < 525625 // 8 and b1[-1][1] > 525625 * 7 // 8
    # tiny matrix degenerates gracefully
    assert _verify_sample_blocks(50) == [(0, 50)]


def test_run_one_sampled_verify(monkeypatch):
    """Huge-output rows verify a stratified row sample (the full fetch +
    full f64 oracle starved the 1-CPU host for tens of minutes)."""
    from benchmarks import suite as suite_mod

    coo = fem_like(1200, dofs=3, neighbors=5, bandwidth=80, seed=22)
    monkeypatch.setattr(suite_mod, "VERIFY_SAMPLE_BYTES", 1 << 10)
    rec = suite_mod.run_one(
        "tiny_sampled", coo, 16, backend="xla", use_autotune=False, rp_time=2
    )
    assert rec["verify"] == "pass"
    assert 0 < rec["verify_rows"] <= 1200
    assert "max_abs_vs_f64_ulp" in rec


def test_load_covered_skips_only_healthy_rows(tmp_path):
    """Coverage-first budgeting: a row counts as covered only if it has a
    timing; error rows must be re-run by later passes."""
    import json

    from benchmarks.suite import load_covered

    doc = {
        "results": [
            {"matrix": "a", "n": 16, "gflops": 10.0},
            {"matrix": "a", "n": 512, "gflops": 3.0},
            # error row: never timed
            {"matrix": "b", "n": 16, "error": "boom"},
        ]
    }
    p = tmp_path / "canon.json"
    p.write_text(json.dumps(doc))
    assert load_covered(p) == {("a", 16), ("a", 512)}
    assert load_covered(tmp_path / "missing.json") == set()


def test_load_failed_collects_error_rows(tmp_path):
    """Error rows in the canonical file feed the deferral ordering (a
    deterministically-failing matrix must not starve never-attempted ones)."""
    import json

    from benchmarks.suite import load_failed

    doc = {
        "results": [
            {"matrix": "a", "n": 16, "gflops": 10.0},
            {"matrix": "b", "n": 512, "error": "RESOURCE_EXHAUSTED"},
            {"matrix": "c", "n": 16, "error": "boom"},
        ]
    }
    p = tmp_path / "canon.json"
    p.write_text(json.dumps(doc))
    assert load_failed(p) == {("b", 512), ("c", 16)}
    assert load_failed(tmp_path / "missing.json") == set()


def test_pack_dev_bytes_matches_upload_tuple():
    """The footprint gate's byte count must equal the arrays SpmmPlan
    actually uploads (ops/plan.py:150-163)."""
    from benchmarks.suite import _pack_dev_bytes
    from sextans_tpu.format.pack import pack
    from sextans_tpu.utils.config import SpmmConfig

    coo = fem_like(600, dofs=3, neighbors=4, bandwidth=60, seed=7)
    packed = pack(coo, SpmmConfig(tile_m=256, window_k=256, block_k=8,
                                  group_blocks=32))
    expect = (packed.vals.nbytes + packed.qrow.nbytes + packed.bcol.nbytes
              + packed.group_mtile.nbytes + packed.group_kwin.nbytes)
    assert _pack_dev_bytes(packed) == expect


def test_footprint_gate_skips_oversized_candidate(monkeypatch):
    """A candidate whose pack + dense extents exceed the HBM budget is
    skipped with race provenance instead of raising RESOURCE_EXHAUSTED
    (the ldoor N=512 livelock)."""
    from benchmarks import suite as suite_mod

    coo = fem_like(1200, dofs=3, neighbors=5, bandwidth=80, seed=22)
    monkeypatch.setattr(suite_mod, "HBM_BUDGET_BYTES", 1)  # gate everything
    try:
        suite_mod.run_one(
            "tiny_gated", coo, 16, backend="xla", use_autotune=True, rp_time=2
        )
    except Exception as e:
        assert "budget" in str(e) or isinstance(e, suite_mod._AllGated)
    else:
        raise AssertionError("expected every candidate to be gated")


def _hybrid_band_coo(seed=2, m=60000, band=40):
    """Circuit-band matrix: near-total DIA cover -> the hybrid gate fires."""
    import numpy as np

    from sextans_tpu.format.coo import COOMatrix

    rng = np.random.default_rng(seed)
    diag = np.arange(m, dtype=np.int64)
    lr = rng.integers(0, m, m * 4)
    lc = np.clip(lr + rng.integers(-band, band + 1, m * 4), 0, m - 1)
    rows = np.concatenate([diag, lr])
    cols = np.concatenate([diag, lc])
    lin = rows * m + cols
    _, keep = np.unique(lin, return_index=True)
    return COOMatrix((m, m), rows[keep].astype(np.int32),
                     cols[keep].astype(np.int32),
                     np.ones(keep.size, np.float32))


def test_untimeable_hybrid_falls_back_to_blocked_race(monkeypatch):
    """A hybrid plan whose compile/timing raises must not keep the row:
    the blocked race runs and its winner lands."""
    import contextlib
    import io

    from benchmarks import suite as suite_mod
    from sextans_tpu.ops import hybrid as hybrid_mod
    from sextans_tpu.utils import autotune as autotune_mod

    coo = _hybrid_band_coo(band=10)
    # the model gate sends the row to the hybrid plan
    monkeypatch.setattr(autotune_mod, "hybrid_cost", lambda split, n: 0.0)

    def boom(self, *a, **k):
        raise RuntimeError("synthetic hybrid compile OOM")

    monkeypatch.setattr(hybrid_mod.HybridSpmmPlan, "__call__", boom)

    import sextans_tpu.utils.timing as timing_mod

    monkeypatch.setattr(
        timing_mod, "time_repeat",
        lambda plan, b, a, be, c, times=1, detail=False:
            (1e-3, {"method": "differential", "times": times})
            if detail else 1e-3)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        # backend="auto": the hybrid-vs-blocked race only runs for
        # auto/hybrid backends (the real suite path)
        rec = suite_mod.run_one("untimeable", coo, 16, "auto", True,
                                verify_gate=True)
    assert "hybrid compile/time failed" in err.getvalue()
    assert not rec["fmt"].startswith("hybrid")
    assert rec["verify"] == "pass"
    assert rec["gflops"] > 0


def test_time_repeat_chained_protocol():
    """The host-chained timing fallback returns a positive time with
    chained method provenance."""
    from sextans_tpu.format.pack import pack
    from sextans_tpu.ops.plan import SpmmPlan
    from sextans_tpu.utils.config import SpmmConfig
    from sextans_tpu.utils.timing import time_repeat_chained

    import numpy as np

    coo = fem_like(600, dofs=3, neighbors=4, bandwidth=60, seed=7)
    packed = pack(coo, SpmmConfig(tile_m=256, window_k=256, block_k=8,
                                  group_blocks=32))
    m, k = coo.shape
    b = np.ones((k, 16), np.float32)
    c = np.zeros((m, 16), np.float32)
    plan = SpmmPlan(packed, 16, backend="xla")
    secs, info = time_repeat_chained(plan, b, 0.85, -2.06, c, times=2,
                                     detail=True)
    assert secs > 0
    assert info == {"method": "chained", "times": 2}


def test_measure_falls_back_to_chained_timing(monkeypatch):
    """run_one lands a timed row even when the in-device repeat chain
    cannot compile: timing provenance says chained."""
    import contextlib
    import io

    from benchmarks import suite as suite_mod

    import sextans_tpu.utils.timing as timing_mod

    def rep_boom(plan, b, a, be, c, times=1, detail=False):
        raise RuntimeError("synthetic jit(rep) OOM")

    monkeypatch.setattr(timing_mod, "time_repeat", rep_boom)
    coo = fem_like(1200, dofs=3, neighbors=5, bandwidth=80, seed=22)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rec = suite_mod.run_one("chainfall", coo, 16, "xla",
                                use_autotune=False, rp_time=2)
    assert "falling back to host-chained timing" in err.getvalue()
    assert rec["gflops"] > 0
    assert rec["timing"]["method"] == "chained"


def test_force_race_ignores_stored_winner(tmp_path, monkeypatch):
    """--force-race drops a stored winner even when the 2x challenge
    thresholds would keep it frozen (mac_econ N=16 sat at 1.6 GFLOPS for
    two rounds with only ~1.7x model headroom)."""
    import contextlib
    import io

    from benchmarks import suite as suite_mod
    from sextans_tpu.utils.autotune import ConfigStore
    from sextans_tpu.utils.config import SpmmConfig

    coo = fem_like(800, dofs=3, neighbors=4, bandwidth=60, seed=9)
    store = ConfigStore(tmp_path / "tuned.json")
    # stored winner with realistic GFLOPS: the 2x challenges stay closed
    store.put("frozen|n=16", SpmmConfig(), fmt="vpu", gflops=50.0)

    import sextans_tpu.utils.timing as timing_mod

    monkeypatch.setattr(
        timing_mod, "time_repeat",
        lambda plan, b, a, be, c, times=1, detail=False:
            (1e-3, {"method": "differential", "times": times})
            if detail else 1e-3)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rec_frozen = suite_mod.run_one(
            "frozen", coo, 16, "xla", True, verify_gate=True, store=store,
        )
    assert "tuned-config store hit" in err.getvalue()
    assert not rec_frozen.get("race")  # stored winner: no race ran

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rec = suite_mod.run_one(
            "frozen", coo, 16, "xla", True, verify_gate=True, store=store,
            force_race=True,
        )
    assert "force-race: ignoring stored winner" in err.getvalue()
    assert rec["verify"] == "pass"


def test_nsweep_resume_state_keeps_measured_drops_errors():
    from benchmarks.nsweep import resume_state

    prev = {"results": [
        {"matrix": "a", "n": 8, "gflops": 1.0},
        {"matrix": "a", "n": 16, "error": "RuntimeError(...)"},
        {"matrix": "b", "n": 8, "gflops": 2.0},
    ]}
    rows, done = resume_state(prev)
    assert done == {("a", 8), ("b", 8)}  # error cell gets retried
    assert [r["matrix"] for r in rows] == ["a", "b"]
    assert resume_state({}) == ([], set())


def test_nsweep_redo_drops_named_measured_cells():
    from benchmarks.nsweep import parse_redo, resume_state

    prev = {"results": [
        {"matrix": "a", "n": 64, "gflops": 79.0},
        {"matrix": "a", "n": 128, "gflops": 158.0},
    ]}
    redo = parse_redo(["a:64"])
    assert redo == {("a", 64)}
    rows, done = resume_state(prev, redo)
    assert done == {("a", 128)}  # the redone cell re-races
    assert [r["n"] for r in rows] == [128]
    assert parse_redo(None) == set()


class _FakeDevice:
    platform = "cpu"
    device_kind = "cpu"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_device_budget_follows_device_limit(monkeypatch):
    """The race budget is the device's own limit less a tenth; a device
    that reports none is unbounded; an explicit override wins."""
    import jax

    from benchmarks import suite as suite_mod

    monkeypatch.setattr(jax, "devices",
                        lambda: [_FakeDevice({"bytes_limit": 1000})])
    assert suite_mod.device_budget_bytes() == 900
    monkeypatch.setattr(jax, "devices", lambda: [_FakeDevice(None)])
    assert suite_mod.device_budget_bytes() == float("inf")
    monkeypatch.setattr(suite_mod, "HBM_BUDGET_BYTES", 123)
    assert suite_mod.device_budget_bytes() == 123


@pytest.mark.parametrize("module", ["suite", "nsweep"])
def test_measurement_mains_refuse_cpu(module, capsys):
    """A measurement path that finds no GPU exits non-zero; it never times
    the CPU under a device metric's name."""
    import importlib

    mod = importlib.import_module(f"benchmarks.{module}")
    assert mod.main(["--n", "16"] if module == "suite" else []) == 2
    assert capsys.readouterr().out == ""


def test_precise_verify_dry_run_lists_reachable_rows(tmp_path, capsys):
    """The banking driver selects gate-false, reachable, timed rows and,
    with --dry-run, touches no device."""
    import json as _json

    from benchmarks import precise_verify as pv

    doc = {"results": [
        {"matrix": "a_like", "n": 16, "gflops": 1.0, "nnz": 10},
        {"matrix": "a_like", "n": 512, "gflops": 1.0, "nnz": 10,
         "meets_1e6_gate": True},
        {"matrix": "b_like", "n": 16, "gflops": 1.0, "nnz": 10,
         "gate_unreachable": True},
        {"matrix": "c_like", "n": 16, "error": "boom"},
    ]}
    results = tmp_path / "results.json"
    results.write_text(_json.dumps(doc))
    todo = pv.reachable_todo(doc["results"])
    assert [(r["matrix"], r["n"]) for r in todo] == [("a_like", 16)]
    assert pv.main(["--results", str(results), "--tuned-configs",
                    str(tmp_path / "t.json"), "--dry-run"]) == 0
    assert _json.loads(results.read_text()) == doc  # dry run writes nothing


def test_precise_gate_sample_runs_in_process():
    """attempt_precise_gate builds the float64 twin of a winning plan in
    this process, verifies it against the oracle and times it."""
    import jax.numpy as jnp

    from benchmarks.precise_verify import attempt_precise_gate
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.format.pack import pack
    from sextans_tpu.ops.golden import golden_spmm_exact
    from sextans_tpu.ops.plan import SpmmPlan
    from sextans_tpu.utils.config import SpmmConfig

    coo = fem_like(300, dofs=3, neighbors=4, bandwidth=40, seed=3)
    cfg = SpmmConfig(tile_m=64, window_k=128, block_k=8, group_blocks=16)
    packed = pack(coo, cfg)
    plan = SpmmPlan(packed, 16)
    rng = np.random.default_rng(1)
    b = rng.standard_normal((coo.shape[1], 16)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], 16)).astype(np.float32)
    csr = CSRMatrix.from_coo(coo)
    exact = golden_spmm_exact(csr, b, 0.85, -2.06, c)
    ulp = float(np.spacing(np.float32(np.abs(exact).max())))
    out = attempt_precise_gate(
        plan=plan, packed=packed, cfg=cfg, split=None, n=16, name="t",
        coo=coo, csr=csr, b_dev=jnp.asarray(b), c_dev=jnp.asarray(c),
        alpha=0.85, beta=-2.06, exact=exact, fetch=np.asarray, ulp=ulp,
        full_device=False,
    )
    sample = out["precise_sample"]
    assert sample["backend"] == "xla"
    assert sample["max_abs_vs_f64"] <= 1.5 * ulp
    assert sample["ms"] > 0
