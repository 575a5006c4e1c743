"""Headline benchmark: SpMM GFLOPS on the GPU, one matrix, N=512.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": "GFLOPS", "vs_baseline": N, ...}

Baseline = the reference U280 bitstream's structural peak, ~259 FP32 GFLOP/s
(BASELINE.md: 64 nnz/cycle x 16 FLOP x 253 MHz). GFLOPS formula matches the
reference host: 2*N*(nnz+M)/t (src/sextans-host.cpp:255-259). Each format's
plan is timed as the median of 20 calls, each ended by block_until_ready;
the fastest format that passes the reference gate is reported.

Without a GPU it exits non-zero and prints no result. Diagnostics, the
device kind and the card's name and power limit go to stderr; stdout
carries exactly the one JSON line.
"""

import json
import sys

import numpy as np

U280_PEAK_GFLOPS = 259.0


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main():
    from sextans_tpu.utils.device_info import (
        card_name_and_power_limit,
        require_gpu,
    )

    dev = require_gpu()
    from sextans_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax.numpy as jnp

    from sextans_tpu.format.coo import COOMatrix
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.format.pack import pack
    from sextans_tpu.format.pack_ell import pack_ell
    from sextans_tpu.format.pack_mxu import pack_mxu
    from sextans_tpu.ops.golden import golden_spmm_exact
    from sextans_tpu.ops.plan import SpmmPlan
    from sextans_tpu.utils.config import SpmmConfig
    from sextans_tpu.utils.timing import time_call
    from sextans_tpu.utils.verify import gflops, verify

    log(f"device: {dev.device_kind} x{len(__import__('jax').devices())}")
    log(f"card: {card_name_and_power_limit()}")

    # nasa4704-shaped banded matrix (the reference's canonical test size)
    name = "banded4704"
    coo = COOMatrix.random(4704, 4704, 104756, seed=42, banded=True,
                           bandwidth=300)
    m, k = coo.shape
    n = 512
    rng = np.random.default_rng(0)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    alpha, beta = 0.85, -2.06
    exact = golden_spmm_exact(CSRMatrix.from_coo(coo), b, alpha, beta, c)
    b_dev, c_dev = jnp.asarray(b), jnp.asarray(c)

    candidates = [
        ("vpu", pack(coo, SpmmConfig())),
        ("mxu", pack_mxu(coo, SpmmConfig(tile_m=1024, window_k=4096,
                                         block_k=32, group_blocks=16))),
        ("ell", pack_ell(coo, SpmmConfig())),
    ]
    best = None
    for fmt, packed in candidates:
        plan = SpmmPlan(packed, n)
        first, secs, out = time_call(plan, b_dev, alpha, beta, c_dev)
        got = np.asarray(out)
        res = verify(exact.astype(np.float32), got)
        log(f"  {fmt} ({plan.backend}): compile+first {first:.2f} s, "
            f"median {secs * 1e3:.3f} ms, gate {'pass' if res.passed else 'FAIL'}")
        if res.passed and (best is None or secs < best[1]):
            best = (plan, secs, got)
    if best is None:
        log("no format passed the reference gate")
        return 1
    plan, secs, got = best
    max_abs = float(np.abs(got - exact).max())
    ulp = float(np.spacing(np.float32(np.abs(exact).max())))
    value = gflops(coo.nnz, m, n, secs)
    print(json.dumps({
        "metric": f"spmm_gflops_{name}_n{n}",
        "value": round(value, 2),
        "unit": "GFLOPS",
        "vs_baseline": round(value / U280_PEAK_GFLOPS, 3),
        "backend": plan.backend,
        "device_kind": dev.device_kind,
        "max_abs_vs_f64": max_abs,
        "max_abs_vs_f64_ulp": round(max_abs / ulp, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
