"""Bank the 1e-6 max-abs gate on canonical rows via measured precise samples.

The BASELINE.md north star asks for max-abs error <= 1e-6 vs the f64
oracle (the reference's own gate is looser: 1e-4 relative / <2% mismatch,
src/sextans-host.cpp:272-282). Round 4 closed the *accounting* — every row
carries gate provenance — but banked zero passes. This module closes the
*evidence*:

* ``attempt_precise_gate`` — shared by suite.py's per-row flow and the
  standalone driver below: builds the precise twin of a row's winning
  plan (float64 accumulation in the engines), measures its error against
  the row's oracle, times it, and returns the gate fields. The row's
  HEADLINE timing stays the fast engine's; the gate rides the measured
  ``precise_sample`` (run, verified, timed — not an estimate).
* ``main`` — the banking driver: walks a suite results file, re-runs the
  precise sample in this one process for every reachable row whose gate is
  still false, and rewrites the rows in place with provenance.

Usage:
    python benchmarks/precise_verify.py --results results.json
        --tuned-configs tuned.json [--only amazon] [--n 16 512]
        [--max-nnz N] [--dry-run]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))


def log(msg):
    print(f"[precise {datetime.now().strftime('%H:%M:%S')}] {msg}",
          file=sys.stderr, flush=True)


def _precise_plan(plan, packed, cfg, split, n, pack_cache=None,
                  cache_name=None):
    """Precise twin of a winning plan, sharing the pack's device uploads."""
    from sextans_tpu.ops.plan import SpmmPlan

    if split is not None:
        from sextans_tpu.ops.hybrid import HybridSpmmPlan

        return HybridSpmmPlan(
            split, n,
            residue_config=plan.residue_config.with_(precise=1),
            residue_fmt=plan.residue_fmt,
            pack_cache=pack_cache,
            cache_name=cache_name,
            precise=1,
        )
    ppacked = dataclasses.replace(packed, config=cfg.with_(precise=1))
    ppacked.__dict__["_dev_cache"] = packed.__dict__.setdefault(
        "_dev_cache", {}
    )
    return SpmmPlan(ppacked, n)


def _time_sample(pplan, b_dev, c_dev, alpha, beta):
    """Short measured timing of the precise plan (sample provenance, not
    the headline protocol): escalate an in-device repeat chain until the
    span is ~0.25 s, capped at 256 repeats."""
    from sextans_tpu.utils.timing import time_repeat

    times = 4
    secs = time_repeat(pplan, b_dev, alpha, beta, c_dev, times=times)
    while secs * times < 0.25 and times < 256:
        times = min(256, max(times * 4, int(0.3 / max(secs, 1e-7))))
        secs = time_repeat(pplan, b_dev, alpha, beta, c_dev, times=times)
    return secs, times


def attempt_precise_gate(
    *,
    plan,
    packed,
    cfg,
    split,
    n,
    name,
    coo,
    csr,
    b_dev,
    c_dev,
    alpha,
    beta,
    exact,
    fetch,
    ulp,
    full_device: bool,
    c_host=None,
    pack_cache=None,
    time_it: bool = True,
) -> dict:
    """Run the precise gate sample for one row; returns the rec updates.

    ``exact``/``fetch`` are the row's oracle and its (possibly sampled)
    fetch projection; ``full_device`` upgrades a passing sample to the
    exact full-matrix max-abs via utils/device_verify. The headline row
    timing is untouched — the sample carries its own measured ms/gflops.
    """
    from sextans_tpu.utils.verify import gflops

    m = coo.shape[0]
    cache_name = f"{name}@n{n}-residue" if split is not None else None
    try:
        pplan = _precise_plan(plan, packed, cfg, split, n,
                              pack_cache=pack_cache, cache_name=cache_name)
        pgot_dev = pplan(b_dev, alpha, beta, c_dev)
        err = float(np.abs(fetch(pgot_dev) - exact).max())
        if err <= 1e-6 and full_device:
            from sextans_tpu.utils.device_verify import device_full_check

            fv = device_full_check(
                pgot_dev, csr, b_dev, alpha, beta,
                c_host if c_host is not None else np.asarray(c_dev),
            )
            err = max(err, fv["max_abs_vs_f64"])
        pgot_dev = None
    except Exception as e:
        log(f"  precise run failed: {str(e)[:120]}")
        return {"gate_note": f"precise-failed:{type(e).__name__}"}
    log(f"  precise: max_abs {err:.2e} ({err / ulp:.2f} ulp)")
    level = 1
    sample_backend = getattr(pplan, "backend", "hybrid")
    sample = {
        "level": level,
        "backend": sample_backend,
        "max_abs_vs_f64": err,
        "max_abs_vs_f64_ulp": round(err / ulp, 2),
    }
    if time_it:
        try:
            secs, times = _time_sample(pplan, b_dev, c_dev, alpha, beta)
            sample["ms"] = round(secs * 1e3, 3)
            sample["rp_time"] = times
            sample["gflops"] = round(gflops(coo.nnz, m, n, secs), 2)
        except Exception as e:
            sample["timing_error"] = str(e)[:90]
    out = {"precise_sample": sample}
    if err <= 1e-6:
        out["meets_1e6_gate"] = True
        out["gate_note"] = f"precise-gate:level{level}"
    else:
        out["gate_note"] = f"precise-missed:{err:.2e}"
        # measured floor evidence: within ~1 ulp of max|C| — the f32
        # faithful-rounding floor (docs/ACCURACY.md "the last half ulp")
        if err <= 1.05 * ulp:
            out["gate_floor_evidence"] = (
                f"best-compensated:{err / ulp:.2f}ulp"
            )
    return out


# ----------------------------------------------------------------- driver


def _rebuild_row(row, coo, store, pack_cache, n):
    """Reconstruct a canonical row's winning plan from the tuned store.

    Returns (plan, packed, cfg, split)."""
    from sextans_tpu.ops.plan import SpmmPlan

    name = row["matrix"]
    key = f"{name}|n={n}"
    cfg = store.get(key) if store is not None else None
    meta = (store.meta(key) or {}) if store is not None else {}
    fmt = meta.get("fmt", row.get("fmt", "vpu"))
    if cfg is None:
        # fall back to the row's recorded shape knobs
        from sextans_tpu.utils.config import SpmmConfig

        cfg = SpmmConfig(
            tile_m=row.get("tile_m", 512),
            window_k=row.get("window_k", 2048),
            block_k=row.get("block_k", 8),
        )
    if fmt.startswith("hybrid"):
        from sextans_tpu.ops.hybrid import HybridSpmmPlan

        residue_fmt = fmt.split("+", 1)[1] if "+" in fmt else None
        split = pack_cache.get_or_split(name, coo, n=n)
        plan = HybridSpmmPlan(
            split, n,
            residue_config=cfg if residue_fmt else None,
            residue_fmt=residue_fmt,
            pack_cache=pack_cache,
            cache_name=f"{name}@n{n}-residue",
        )
        return plan, plan._residue_plan.packed, plan.residue_config, split
    reorder2d = bool(meta.get("reorder2d"))
    reorder_cols = bool(row.get("reorder") in ("cols", "2d")) or reorder2d
    packed = pack_cache.get_or_pack(
        name, coo, cfg, fmt, reorder_cols, reorder_rows=reorder2d
    )
    plan = SpmmPlan(packed, n)
    return plan, packed, cfg, None


def bank_row(row, coo, store, pack_cache, session):
    """Run the precise gate sample for one canonical row; mutates row."""
    import jax.numpy as jnp

    from benchmarks.suite import (
        VERIFY_SAMPLE_BYTES,
        _csr_take_rows,
        _verify_sample_blocks,
    )
    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm_exact

    n = row["n"]
    m, k = coo.shape
    alpha, beta = 0.85, -2.06
    rng = np.random.default_rng(0)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)

    plan, packed, cfg, split = _rebuild_row(row, coo, store, pack_cache, n)
    b_dev = jnp.asarray(b)
    c_dev = jnp.asarray(c)
    csr = CSRMatrix.from_coo(coo)

    full_device = False
    if m * n * 4 > VERIFY_SAMPLE_BYTES:
        blocks = _verify_sample_blocks(m)
        rows_s = np.concatenate(
            [np.arange(s, e, dtype=np.int64) for s, e in blocks]
        )

        def fetch(out):
            if isinstance(out, np.ndarray):
                return out[rows_s]
            return np.asarray(
                jnp.take(out, jnp.asarray(rows_s, dtype=jnp.int32), axis=0)
            )

        sub = _csr_take_rows(csr, rows_s)
        touched = np.unique(sub.indices)
        sub = CSRMatrix(
            (sub.shape[0], int(touched.size)), sub.indptr,
            np.searchsorted(touched, sub.indices).astype(np.int32),
            sub.vals,
        )
        exact = golden_spmm_exact(sub, b[touched], alpha, beta, c[rows_s])
        full_device = True
    else:
        def fetch(out):
            return np.asarray(out)

        exact = golden_spmm_exact(csr, b, alpha, beta, c)

    cmax = row.get("c_max_abs") or float(np.abs(exact).max())
    ulp = float(np.spacing(np.float32(cmax))) or 1e-45

    upd = attempt_precise_gate(
        plan=plan, packed=packed, cfg=cfg, split=split, n=n,
        name=row["matrix"], coo=coo, csr=csr,
        b_dev=b_dev, c_dev=c_dev, alpha=alpha, beta=beta,
        exact=exact, fetch=fetch, ulp=ulp, full_device=full_device,
        c_host=c, pack_cache=pack_cache,
    )
    if "precise_sample" in upd:
        upd["precise_sample"]["session"] = session
    row.update(upd)
    return row


def reachable_todo(rows, only=None, n_filter=None, max_nnz=None):
    todo = []
    for r in rows:
        if "gflops" not in r or r.get("meets_1e6_gate"):
            continue
        if r.get("gate_unreachable"):
            continue
        if only and only not in r["matrix"]:
            continue
        if n_filter and r["n"] not in n_filter:
            continue
        if max_nnz and r.get("nnz", 0) > max_nnz:
            continue
        todo.append(r)
    return todo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", required=True)
    ap.add_argument("--only", default=None)
    ap.add_argument("--n", type=int, nargs="*", default=None)
    ap.add_argument("--max-nnz", type=int, default=None)
    ap.add_argument("--tuned-configs", required=True)
    ap.add_argument("--deadline-ts", type=float, default=None)
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)

    doc = json.loads(Path(args.results).read_text())
    rows = doc.get("results", [])
    todo = reachable_todo(rows, args.only,
                          set(args.n) if args.n else None, args.max_nnz)
    log(f"{len(todo)} reachable gate-false rows to bank")
    for r in todo:
        log(f"  {r['matrix']} N={r['n']}: {r.get('gate_note', '(no note)')}")
    if args.dry_run or not todo:
        return 0

    import jax

    from benchmarks.suite import _gen_cached
    from benchmarks.matrices import suite as suite_gens
    from sextans_tpu.format.pack_cache import PackCache
    from sextans_tpu.utils.autotune import ConfigStore
    from sextans_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU (platform {dev.platform!r}): banking measures on the "
            "GPU only")
        return 2
    session = {
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
    }
    log(f"device: {dev.device_kind}")
    store = ConfigStore(args.tuned_configs)
    pack_cache = PackCache()
    gens = suite_gens("full")

    # small rows first: bank the cheap evidence before any big-row OOM
    todo.sort(key=lambda r: (r.get("nnz", 0), r["n"]))
    done = 0
    coo_cache = {}
    for row in todo:
        if args.deadline_ts and time.time() > args.deadline_ts:
            log("deadline reached; stopping")
            break
        name = row["matrix"]
        if name not in gens:
            log(f"  {name}: no generator; skipping")
            continue
        log(f"== {name} N={row['n']} ({row.get('gate_note', '')}) ==")
        try:
            if name not in coo_cache:
                coo_cache[name] = _gen_cached(name, gens[name])
            bank_row(row, coo_cache[name], store, pack_cache, session)
            done += 1
            log(f"  -> gate={row.get('meets_1e6_gate')} "
                f"note={row.get('gate_note')}")
        except Exception as e:
            log(f"  !! failed: {type(e).__name__}: {str(e)[:200]}")
            row["gate_note"] = (
                f"precise-failed:{type(e).__name__}:{str(e)[:60]}"
            )
            if "RESOURCE_EXHAUSTED" in str(e):
                log("device OOM: stopping this pass")
                break
        # incremental flush after every row
        Path(args.results).write_text(json.dumps(doc, indent=1))
    log(f"banked {done}/{len(todo)} rows")
    Path(args.results).write_text(json.dumps(doc, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
