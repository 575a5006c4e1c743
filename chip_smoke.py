"""Smoke test of the SpMM main path on one NVIDIA GPU.

Runs the entry points a user calls — pack, plan(backend="auto"),
HybridSpmmPlan, SpmmServer and the CLI — in one process, on matrices
generated from a seed at the shapes of their SuiteSparse namesakes
(benchmarks/matrices.py), and checks every result against the float64
oracle: the reference gate (relative error <= 1e-4 on fewer than 2 % of the
elements missing it) and a max-abs error of at most 16 ulp of max|C|
(2 ulp for the precise phase). Each phase prints its engine, compile
seconds, warm per-call time (median of 20 calls, each ended by
block_until_ready), GFLOPS by the reference formula 2*N*(nnz+M)/t, gate and
ulp. A failing phase ends the run with a traceback.

    python chip_smoke.py           # one GPU, every phase
    python chip_smoke.py --four    # four GPUs: the sharded plans only

Without a GPU it exits non-zero and prints no result. The last line of
stdout is one JSON object naming the device JAX reports.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ALPHA, BETA = 0.85, -2.06
ULP_BOUND = 16.0
PRECISE_ULP_BOUND = 2.0  # tests/test_df32.py asserts the same band
REPS = 20
# Rows of the host-side reference gate for outputs too large to fetch.
SAMPLE_BLOCKS, SAMPLE_ROWS = 64, 128

sys.path.insert(0, str(Path(__file__).resolve().parent))


def log(msg: str) -> None:
    print(msg, flush=True)


def operands(coo, n: int, seed: int = 0):
    """Seeded B (K x N) and C (M x N), as float32."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((coo.shape[1], n)).astype(np.float32)
    c = rng.standard_normal((coo.shape[0], n)).astype(np.float32)
    return b, c


def check(coo, b, c, got_dev, *, bound: float, device_oracle: bool) -> dict:
    """Reference gate and ulp error of ``got_dev`` against the float64
    oracle; raises AssertionError when either fails."""
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm_exact
    from sextans_tpu.utils.verify import verify

    csr = CSRMatrix.from_coo(coo)
    if device_oracle:
        # every element against the oracle on the device; the elementwise
        # reference gate on a seeded sample of row blocks on the host
        from sextans_tpu.utils.device_verify import device_full_check

        full = device_full_check(got_dev, csr, b, ALPHA, BETA, c)
        max_abs, cmax = full["max_abs_vs_f64"], full["c_max_abs"]
        m = coo.shape[0]
        starts = np.random.default_rng(1).choice(
            max(1, m - SAMPLE_ROWS), SAMPLE_BLOCKS, replace=False
        )
        rows = np.unique(
            (starts[:, None] + np.arange(SAMPLE_ROWS)[None, :]).ravel()
        )
        got = np.asarray(got_dev[rows])
        exact = _oracle_rows(csr, rows, b, c)
    else:
        got = np.asarray(got_dev)
        exact = golden_spmm_exact(csr, b, ALPHA, BETA, c)
        max_abs = float(np.abs(got - exact).max())
        cmax = float(np.abs(exact).max())
    res = verify(exact.astype(np.float32), got)
    ulp_size = float(np.spacing(np.float32(cmax)))
    ulp = max_abs / ulp_size
    out = {"gate": "pass" if res.passed else "FAIL", "ulp": round(ulp, 3),
           "max_abs_vs_f64": max_abs, "ulp_size": ulp_size}
    assert res.passed, f"reference gate failed: {res}"
    assert ulp <= bound, f"{ulp:.2f} ulp of max|C| exceeds {bound}"
    return out


def _oracle_rows(csr, rows, b, c):
    """float64 oracle on a subset of rows."""
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm_exact

    lens = np.diff(csr.indptr)[rows]
    indptr = np.concatenate(([0], np.cumsum(lens))).astype(np.int64)
    idx = np.concatenate([
        np.arange(csr.indptr[r], csr.indptr[r + 1]) for r in rows
    ]).astype(np.int64)
    sub = CSRMatrix((rows.size, csr.shape[1]), indptr, csr.indices[idx],
                    csr.vals[idx])
    return golden_spmm_exact(sub, b, ALPHA, BETA, c[rows])


def timed_phase(phase: str, matrix: str, coo, n: int, plan, *,
                bound: float = ULP_BOUND, device_oracle: bool = False,
                reps: int = REPS) -> dict:
    """Compile, time and check one plan; prints and returns its record."""
    import jax.numpy as jnp

    from sextans_tpu.utils.timing import time_call
    from sextans_tpu.utils.verify import gflops

    b, c = operands(coo, n)
    b_dev, c_dev = jnp.asarray(b), jnp.asarray(c)
    first, secs, out = time_call(plan, b_dev, ALPHA, BETA, c_dev, reps=reps)
    rec = {
        "phase": phase, "matrix": matrix, "m": coo.shape[0],
        "nnz": coo.nnz, "n": n,
        "engine": getattr(plan, "backend", None)
        or f"hybrid+{plan._residue_plan.backend}",
        "compile_s": round(first, 3), "warm_ms": round(secs * 1e3, 4),
        "gflops": round(gflops(coo.nnz, coo.shape[0], n, secs), 2),
    }
    rec.update(check(coo, b, c, out, bound=bound,
                     device_oracle=device_oracle))
    log(" ".join(f"{k}={v}" for k, v in rec.items()))
    return rec


def phase_pack(phase, matrix, coo, ns, config=None, **kw):
    """``sx.pack`` -> ``sx.plan(backend="auto")`` at each N."""
    import sextans_tpu as sx

    packed = sx.pack(coo, config or sx.SpmmConfig())
    return [timed_phase(phase, matrix, coo, n, sx.plan(packed, n), **kw)
            for n in ns]


def phase_packed(phase, matrix, coo, n, packer, config):
    """Another pack format -> ``SpmmPlan(backend="auto")``."""
    import sextans_tpu as sx

    return timed_phase(phase, matrix, coo, n,
                       sx.SpmmPlan(packer(coo, config), n))


def phase_stencil(matrix, coo, n):
    """``split_structure`` -> ``HybridSpmmPlan`` (diagonals + residue)."""
    import sextans_tpu as sx

    split = sx.split_structure(coo, n=n)
    log(f"  {split.summary()}")
    assert split.diag_offsets.size, "stencil split lifted no diagonals"
    return timed_phase("stencil", matrix, coo, n, sx.HybridSpmmPlan(split, n))


def phase_serve(matrix, coo1, coo2, n):
    """Two matrices of one bucket through one ``SpmmServer``: the second is
    served with zero compilations, counted by JAX's own compile events."""
    import jax

    import sextans_tpu as sx
    from sextans_tpu.utils.verify import gflops

    compiles = []

    def on_event(event, duration, **kw):
        if event in ("/jax/core/compile/backend_compile_duration",
                     "/jax/core/compile/jaxpr_trace_duration"):
            compiles.append(event)

    server = sx.SpmmServer(n)
    recs = []
    jax.monitoring.register_event_duration_secs_listener(on_event)
    try:
        for i, coo in enumerate((coo1, coo2)):
            before = len(compiles)
            t0 = time.perf_counter()
            plan = server.plan(coo)
            b, c = operands(coo, n, seed=i)
            got = plan(b, ALPHA, BETA, c)
            secs = time.perf_counter() - t0
            rec = {"phase": "serve", "matrix": f"{matrix}#{i}", "n": n,
                   "engine": server.backend, "bucket_new": plan.bucket_new,
                   "compiles": len(compiles) - before,
                   "first_call_s": round(secs, 3)}
            t0 = time.perf_counter()
            for _ in range(5):
                got = plan(b, ALPHA, BETA, c)
            warm = (time.perf_counter() - t0) / 5
            rec["warm_ms_host_padded"] = round(warm * 1e3, 3)
            rec["gflops"] = round(gflops(coo.nnz, coo.shape[0], n, warm), 2)
            rec.update(check(coo, b, c, got, bound=ULP_BOUND,
                             device_oracle=False))
            log(" ".join(f"{k}={v}" for k, v in rec.items()))
            recs.append(rec)
    finally:
        jax.monitoring.unregister_event_duration_listener(on_event)
    assert not recs[1]["bucket_new"], "second matrix opened a new bucket"
    assert recs[1]["compiles"] == 0, (
        f"second matrix compiled {recs[1]['compiles']} times"
    )
    return recs


def phase_cli(coo, n: int = 16) -> dict:
    """``cli.main`` in this process on a Matrix Market file."""
    from sextans_tpu.cli import main as cli_main
    from sextans_tpu.io.mtx import write_mtx

    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "a.mtx"
        write_mtx(path, coo)
        rc = cli_main([str(path), str(n), "10", str(ALPHA), str(BETA)])
    rec = {"phase": "cli", "m": coo.shape[0], "nnz": coo.nnz, "n": n,
           "rc": rc}
    log(" ".join(f"{k}={v}" for k, v in rec.items()))
    assert rc == 0, f"cli.main returned {rc}"
    return rec


def peak_bytes() -> int | None:
    import jax

    return (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")


def full_size_matrices() -> dict:
    """The phases' matrices, generated from seeds at the shapes of their
    SuiteSparse namesakes (rows, nnz): cant (62,451, 3.78 M), webbase-1M
    (1,000,005, 2.62 M), a 64^3 7-point Laplacian (262,144, 1.83 M),
    pdb1HYS (36,417, 3.98 M) and ldoor (952,203, 45.3 M)."""
    from benchmarks.matrices import fem_like, powerlaw_like, stencil_3d

    return {
        "cant_like": lambda: fem_like(62451, dofs=3, neighbors=21, seed=2),
        "cant_like_seed3": lambda: fem_like(62451, dofs=3, neighbors=21,
                                            seed=3),
        "webbase1M_like": lambda: powerlaw_like(1000005, avg_degree=3,
                                                seed=19),
        "laplace3d_64": lambda: stencil_3d(64, seed=12),
        "pdb1HYS_like": lambda: fem_like(36417, dofs=9, neighbors=13, seed=4),
        "cli_4704": lambda: fem_like(4704, dofs=3, neighbors=22, seed=5),
        "ldoor_like": lambda: fem_like(952203, dofs=3, neighbors=16,
                                       bandwidth=1200, seed=7),
    }


def one_card_phases(mats: dict, ns=(16, 512), n_mid: int = 128,
                    n_large: int = 512) -> list:
    """Every one-GPU phase; ``mats`` maps the names of
    :func:`full_size_matrices` to generators."""
    import sextans_tpu as sx

    recs = []
    cant = mats["cant_like"]()
    recs += phase_pack("fem", "cant_like", cant, ns)
    recs.append(phase_packed("scattered", "webbase1M_like",
                             mats["webbase1M_like"](), n_mid, sx.pack_ell,
                             sx.SpmmConfig()))
    recs.append(phase_stencil("laplace3d_64", mats["laplace3d_64"](), n_mid))
    pdb = mats["pdb1HYS_like"]()
    recs.append(phase_packed("slab", "pdb1HYS_like", pdb, n_mid, sx.pack_mxu,
                             sx.SpmmConfig(block_k=32, group_blocks=16)))
    recs.append(phase_packed("edge", "pdb1HYS_like", pdb, n_mid,
                             sx.pack_edge,
                             sx.SpmmConfig(tile_m=4096, window_k=8192)))
    del pdb
    recs += phase_serve("cant_like", cant, mats["cant_like_seed3"](), n_mid)
    recs.append(phase_cli(mats["cli_4704"]()))
    recs += phase_pack("precise", "cant_like", cant, (n_mid,),
                       config=sx.SpmmConfig(precise=True),
                       bound=PRECISE_ULP_BOUND)
    del cant
    recs += phase_pack("large", "ldoor_like", mats["ldoor_like"](),
                       (n_large,), device_oracle=True, reps=5)
    log(f"large phase peak_bytes_in_use={peak_bytes()}")
    return recs


def four_card_phases(mats: dict, n: int = 128) -> list:
    """Row-shard (nnz-balanced) and K-shard plans on ldoor_like, the
    row-sharded ELL plan on webbase1M_like and the sharded hybrid plan on
    laplace3d_64, each against the one-card plan and the float64 oracle."""
    import jax.numpy as jnp

    import sextans_tpu as sx

    recs = []
    ldoor = mats["ldoor_like"]()
    cfg = sx.SpmmConfig()
    b, c = operands(ldoor, n)
    one = np.asarray(sx.plan(sx.pack(ldoor, cfg), n)(
        jnp.asarray(b), ALPHA, BETA, jnp.asarray(c)))
    plans = (
        ("row", sx.ShardedSpmmPlan(
            sx.pack_sharded(ldoor, 4, cfg, balance="nnz"), n)),
        ("k", sx.ShardedSpmmPlanK(sx.pack_sharded_k(ldoor, 4, cfg), n)),
    )
    for mode, plan in plans:
        recs.append(_vs_one_card(f"four_{mode}", "ldoor_like", ldoor, n,
                                 plan, one, device_oracle=True, reps=5))
    del ldoor, one, plans
    web = mats["webbase1M_like"]()
    b, c = operands(web, n)
    one = np.asarray(sx.SpmmPlan(sx.pack_ell(web, cfg), n)(
        jnp.asarray(b), ALPHA, BETA, jnp.asarray(c)))
    recs.append(_vs_one_card(
        "four_ell", "webbase1M_like", web, n,
        sx.ShardedSpmmPlan(sx.pack_sharded(web, 4, cfg, fmt="ell"), n), one))
    del web, one
    lap = mats["laplace3d_64"]()
    split = sx.split_structure(lap, n=n)
    b, c = operands(lap, n)
    one = np.asarray(sx.HybridSpmmPlan(split, n)(b, ALPHA, BETA, c))
    recs.append(_vs_one_card("four_hybrid", "laplace3d_64", lap, n,
                             sx.ShardedHybridPlan(split, n, 4), one))
    return recs


def _vs_one_card(phase, matrix, coo, n, plan, one, **kw) -> dict:
    """A sharded plan's phase record plus its distance from the one-card
    result; both are within ULP_BOUND of the oracle, so they differ by at
    most twice that."""
    rec = timed_phase(phase, matrix, coo, n, plan, **kw)
    b, c = operands(coo, n)
    got = np.asarray(plan(b, ALPHA, BETA, c))
    diff_ulp = float(np.abs(got - one).max()) / rec["ulp_size"]
    rec["ulp_vs_one_card"] = round(diff_ulp, 3)
    log(f"  {phase}: ulp_vs_one_card={rec['ulp_vs_one_card']}")
    assert diff_ulp <= 2 * ULP_BOUND, f"{phase} differs from one card"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded plans, on four GPUs")
    args = ap.parse_args(argv)

    import jax

    from sextans_tpu.runtime import native
    from sextans_tpu.utils.cache import enable_compilation_cache
    from sextans_tpu.utils.device_info import (
        card_name_and_power_limit,
        require_gpu,
    )

    dev = require_gpu()
    devices = jax.devices()
    if len(devices) != (4 if args.four else 1):
        raise SystemExit(
            f"{'--four' if args.four else 'this run'} needs "
            f"{4 if args.four else 1} GPU(s), JAX sees {len(devices)}"
        )
    log(f"compile cache: {enable_compilation_cache()}")
    log(f"jax.devices(): {devices}")
    log(f"device_kind: {dev.device_kind}")
    log(f"nvidia-smi name, power.limit: {card_name_and_power_limit()}")
    log(f"native packer: {native.available()}")
    t0 = time.perf_counter()
    mats = full_size_matrices()
    recs = four_card_phases(mats) if args.four else one_card_phases(mats)
    log(f"{len(recs)} checks passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
