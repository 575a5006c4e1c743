"""Benchmark suite runner: SpMM GFLOPS across matrices and N widths.

The measurement protocol mirrors the reference host (src/sextans-host.cpp):
GFLOPS = 2*N*(nnz+M)/t with the kernel repeated through a data-dependency
chain (the rp_time analog), after a golden-model verification gate. Each row
additionally reports max-abs error against the float64 oracle
(golden_spmm_exact) — the BASELINE.md 1e-6 north-star gate.

Provenance: every run embeds a session header (platform, device kind,
device count, timestamp) so rows are traceable to the card they ran on.
The suite measures on the GPU only: without one it exits non-zero.

Usage:
    python benchmarks/suite.py [--scale small|full] [--n 16 128 512]
        [--backend auto|xla|mxu] [--autotune] [--out results.json]
        [--tuned-configs tuned.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from datetime import datetime, timezone
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _pack_for(coo, cfg, fmt, reorder_cols, reorder_rows=False):
    from sextans_tpu.format.pack import pack
    from sextans_tpu.format.pack_edge import pack_edge
    from sextans_tpu.format.pack_mxu import pack_mxu

    if fmt == "mxu":
        return pack_mxu(coo, cfg, reorder_cols=reorder_cols,
                        reorder_rows_=reorder_rows)
    if fmt == "edge":
        return pack_edge(coo, cfg, reorder_cols=reorder_cols,
                         reorder_rows_=reorder_rows)
    if fmt == "ell":
        from sextans_tpu.format.pack_ell import pack_ell

        return pack_ell(coo, cfg)
    return pack(coo, cfg, reorder_cols=reorder_cols,
                reorder_rows_=reorder_rows)


def _pack_dev_bytes(packed) -> int:
    """Exact device bytes of a packed operand's one-time upload (the arrays
    SpmmPlan moves to HBM, ops/plan.py:150-163)."""
    total = 0
    for attr in ("vals", "cols", "fold_rows", "meta", "qm", "qrow", "bcol",
                 "group_mtile", "group_kwin"):
        a = getattr(packed, attr, None)
        if a is not None and hasattr(a, "nbytes"):
            total += int(a.nbytes)
    return total


def _est_exec_bytes(packed, n: int, m: int, k: int) -> int:
    """Estimated peak device bytes of one plan call on ``packed``: the
    resident b/c uploads + the jit's padded b/c/out transients + the pack
    upload + engine-specific extents the generic formula misses. For ELL
    that is the post-engine fold scatter (an extra (m_padded, n) copy —
    out is consumed by ``out.at[fold_rows].add``) and the virtual-row strip
    temporaries (2 x (n_virt, n))."""
    n_pad = n
    est = (
        _pack_dev_bytes(packed)
        + 4 * n * (k + 2 * m)
        + 4 * n_pad * (packed.k_padded + 2 * packed.m_padded)
    )
    n_virt = getattr(packed, "n_virt", None)
    if n_virt is not None:  # ELL pack: fold copy + virt strip temps
        est += 4 * n_pad * (packed.m_padded + 2 * n_virt)
    return est


def _release_hybrid_dev(plan, packed) -> None:
    """Free an abandoned HybridSpmmPlan's device residency: the dense
    component uploads, the prebuilt arg tuples aliasing them, the residue
    SpmmPlan's upload tuple, and the residue pack's ``_dev_cache`` (also
    pinned by pack_cache._mem). Without this the blocked race that
    replaces an untimeable hybrid runs with the hybrid's multi-GB buffers
    still resident (webbase1M N=512: every blocked candidate hit
    RESOURCE_EXHAUSTED after the hybrid attempt OOMed)."""
    for attr in ("_dev", "_dense_args", "_res_args"):
        plan.__dict__.pop(attr, None)
    rp = plan.__dict__.pop("_residue_plan", None)
    if rp is not None:
        rp.__dict__.pop("_dev", None)
    if packed is not None:
        packed.__dict__.pop("_dev_cache", None)


class _AllGated(RuntimeError):
    """Every race candidate exceeded the device-memory budget."""


def _gen_cached(name, gen):
    """Disk-cache generated suite matrices (the 1M-row generators cost
    minutes per overnight pass; generation is deterministic per name)."""
    import tempfile

    from sextans_tpu.format.coo import COOMatrix

    cache = Path(tempfile.gettempdir()) / "sextans_suite_cache"
    f = cache / f"{name}.npz"
    if f.exists():
        try:
            z = np.load(f)
            return COOMatrix(
                (int(z["m"]), int(z["k"])), z["rows"], z["cols"], z["vals"]
            )
        except Exception:
            pass
    coo = gen()
    try:
        cache.mkdir(parents=True, exist_ok=True)
        np.savez(f, m=coo.shape[0], k=coo.shape[1], rows=coo.rows,
                 cols=coo.cols, vals=coo.vals)
    except OSError:
        pass
    return coo


VERIFY_SAMPLE_BYTES = 512 << 20  # sample the verify when full C exceeds this


def _verify_sample_blocks(m, n_blocks=64, block_rows=128, seed=0):
    """Deterministic stratified row blocks covering the full M range.

    Strata are equally spaced with a seeded jitter inside each stratum so
    banded/diagonal structure cannot systematically align with the sample
    grid."""
    block_rows = min(block_rows, m)
    n_blocks = max(1, min(n_blocks, m // block_rows))
    starts = np.linspace(0, m - block_rows, n_blocks).astype(np.int64)
    stride = max(1, (m - block_rows) // max(n_blocks - 1, 1))
    rng = np.random.default_rng(seed)
    starts = np.minimum(
        m - block_rows,
        starts + rng.integers(0, max(stride - block_rows, 1), starts.size),
    )
    starts = np.unique(starts)
    return [(int(s), int(s + block_rows)) for s in starts]


def _csr_take_rows(csr, rows):
    """Row-sliced CSRMatrix (vectorized nnz gather)."""
    from sextans_tpu.format.csr import CSRMatrix

    lens = np.diff(csr.indptr)[rows]
    total = int(lens.sum())
    out_indptr = np.zeros(rows.size + 1, dtype=np.int64)
    np.cumsum(lens, out=out_indptr[1:])
    starts = csr.indptr[rows]
    idx = np.repeat(starts - out_indptr[:-1], lens) + np.arange(total)
    return CSRMatrix((int(rows.size), csr.shape[1]), out_indptr,
                     csr.indices[idx], csr.vals[idx])


# Device-memory budget for a race candidate's estimated peak footprint:
# None means the device's own limit (memory_stats()["bytes_limit"]) less a
# tenth for compiler scratch and the verify buffers.
HBM_BUDGET_BYTES = None


def device_budget_bytes() -> float:
    """The race's device-memory budget (``HBM_BUDGET_BYTES`` if set)."""
    if HBM_BUDGET_BYTES is not None:
        return HBM_BUDGET_BYTES
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    limit = stats.get("bytes_limit")
    return 0.9 * limit if limit else float("inf")


def round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


def cover_upper_bound(coo):
    """Cheap O(nnz) pre-screen before the full hybrid split: upper-bound
    the dense cover from diagonal/hub histograms (split_structure + residue
    re-analysis costs ~10 min on 45M-edge matrices, and the hybrid gate
    runs per N row). Includes dense head ROWS (split_structure lifts up to
    256 rows) so a row-hub-dominated matrix is never screened out even when
    its true dense cover clears the threshold."""
    diag_id = coo.cols.astype(np.int64) - coo.rows.astype(np.int64)
    dcount = np.bincount(diag_id - diag_id.min())
    diag_ub = int(np.sort(dcount)[::-1][:64].sum())
    cdeg = np.bincount(coo.cols, minlength=coo.shape[1])
    hub_ub = int(np.sort(cdeg)[::-1][:2048].sum())
    rdeg = np.bincount(coo.rows, minlength=coo.shape[0])
    row_ub = int(np.sort(rdeg)[::-1][:256].sum())
    return (diag_ub + hub_ub + row_ub) / max(coo.nnz, 1)


def candidate_list(coo_for_tuning, coo, n, base_ro, first=None):
    """The analytic race candidates for one (matrix, N) row — the model's
    top-3 plus family-diversity picks plus 2-D-reordered blocked candidates
    on hub-heavy matrices. Shared by run_one's measured race and
    prepack.py's host-side cache warmer (they MUST enumerate identically,
    or the warmed packs miss). Returns [(cfg, fmt, (r_cols, r_rows))]."""
    from sextans_tpu.utils.autotune import choose_backend as _cb3

    cands = [
        (r.config, r.fmt, base_ro)
        for r in _cb3(coo_for_tuning, n=n, top=3)
    ]
    if first is not None and first != (cands[0][0], cands[0][1]):
        cands.insert(0, (*first, base_ro))
    # ensure family diversity: add the best candidate of any family
    # missing from the model's top picks
    fams = {f for _, f, _ in cands}
    from sextans_tpu.utils.autotune import (
        choose_config,
        choose_config_edge,
        choose_config_ell,
        choose_config_mxu,
    )

    best_pred = _cb3(coo_for_tuning, n=n, top=1)[0].predicted_cost
    for fam, chooser in (
        ("vpu", choose_config),
        ("mxu", choose_config_mxu),
        ("edge", choose_config_edge),
        ("ell", choose_config_ell),
    ):
        if fam not in fams:
            extra_c = chooser(coo_for_tuning, n=n, top=1)
            # racing a family the model puts >5x off the best is
            # wasted device time even when the model is rough
            if extra_c and extra_c[0].predicted_cost < 5 * best_pred:
                ro = base_ro if fam != "ell" else (False, False)
                cands.append((extra_c[0].config, fam, ro))
    # hub-heavy matrices: add 2-D degree-reordered blocked candidates
    # (the round-3 lever — the hub core clusters into dense blocks;
    # only a measured race can tell whether it beats edge/hybrid)
    cdeg = np.bincount(coo.cols, minlength=coo.shape[1])
    hub_mass = np.sort(cdeg)[::-1][:2048].sum() / max(coo.nnz, 1)
    if hub_mass >= 0.3 and coo.nnz <= 8_000_000:
        from sextans_tpu.format.pack import reorder_columns as _rc
        from sextans_tpu.format.pack import reorder_rows as _rr

        coo2d, _ = _rc(coo)
        coo2d, _ = _rr(coo2d)
        for fam, chooser in (
            ("vpu", choose_config), ("mxu", choose_config_mxu),
        ):
            c2 = chooser(coo2d, n=n, top=1)
            if c2:
                cands.append((c2[0].config, fam, (True, True)))
        log(f"  2d-reorder candidates added (hub mass {hub_mass:.0%})")
    return cands


def run_one(name, coo, n, backend, use_autotune, rp_time=10, verify_gate=True,
            reorder_cols=False, store=None, hybrid="auto", pack_cache=None,
            force_race=False):
    import jax.numpy as jnp

    from sextans_tpu.format.csr import CSRMatrix
    from sextans_tpu.ops.golden import golden_spmm, golden_spmm_exact
    from sextans_tpu.ops.plan import SpmmPlan
    from sextans_tpu.utils.autotune import choose_backend
    from sextans_tpu.utils.config import SpmmConfig
    from sextans_tpu.utils.timing import time_repeat
    from sextans_tpu.utils.verify import gflops, verify

    m, k = coo.shape
    alpha, beta = 0.85, -2.06
    rng = np.random.default_rng(0)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)

    coo_for_tuning = coo
    if reorder_cols:
        from sextans_tpu.format.pack import reorder_columns

        coo_for_tuning, _ = reorder_columns(coo)

    key = f"{name}|n={n}"
    fmt = "vpu"
    cfg = SpmmConfig()
    if backend == "mxu":
        fmt = "mxu"
        cfg = SpmmConfig(tile_m=1024, window_k=4096, block_k=128,
                         group_blocks=8)
    stored = store.get(key) if store is not None else None
    if stored is not None and force_race:
        # Targeted re-race (--force-race): drop the stored winner entirely
        # so the full race decides.
        log("  force-race: ignoring stored winner "
            f"{(store.meta(key) or {}).get('fmt')}")
        stored = None
    split = None
    stored_hybrid_fmt = None
    if stored is not None:
        cfg = stored
        meta = store.meta(key) or {}
        fmt = meta.get("fmt", fmt)
        if fmt.startswith("hybrid"):
            # stored hybrid row: rebuild the split, reuse the stored
            # residue config/format
            stored_hybrid_fmt = fmt.split("+", 1)[1] if "+" in fmt else None
            fmt = "hybrid"
        log(f"  tuned-config store hit: {fmt} {cfg}")
    elif use_autotune:
        best = choose_backend(coo_for_tuning, n=n)[0]
        cfg, fmt = best.config, best.fmt
        if fmt != "vpu" and backend == "xla":
            # caller pinned the block-format engine; take its best config
            from sextans_tpu.utils.autotune import choose_config

            cfg, fmt = choose_config(coo_for_tuning, n=n)[0].config, "vpu"
        log(f"  autotune: fmt={fmt} {cfg}")

    # structure split: diagonals + dense head cols/rows absorb what block
    # formats handle worst. Engage only when the MODELED hybrid bytes beat
    # the best single-format bytes (a blanket coverage rule mis-fires on
    # banded FEM, where diagonals are dense but the block engines are
    # already near their floor); the measured race below then decides.
    if fmt == "hybrid" or (hybrid == "auto" and use_autotune and stored is None):
        from sextans_tpu.ops.hybrid import split_structure
        from sextans_tpu.utils.autotune import choose_backend as _cb
        from sextans_tpu.utils.autotune import hybrid_cost

        screened_out = (
            fmt != "hybrid"
            and coo.nnz > 5_000_000
            and cover_upper_bound(coo) < 0.3
        )
        if screened_out:
            cand = None
        elif pack_cache is not None:
            cand = pack_cache.get_or_split(name, coo, n=n)
        else:
            cand = split_structure(coo, n=n)
        dense_cover = (
            0.0
            if cand is None
            else (cand.diag_nnz + cand.head_nnz + cand.head_row_nnz)
            / max(coo.nnz, 1)
        )
        if fmt == "hybrid":
            split = cand
        elif dense_cover >= 0.3 and coo.nnz >= 50_000:
            full_cost = _cb(coo_for_tuning, n=n)[0].predicted_cost
            h_cost = hybrid_cost(cand, n=n)
            # a force-race replaces model decisions with measured ones:
            # race hybrid whenever the model puts it anywhere near blocked
            gate = 1.25 if force_race else 0.8
            if h_cost < gate * full_cost:
                split = cand
            log(
                f"  hybrid model: {h_cost / 1e6:.1f}M vs blocked "
                f"{full_cost / 1e6:.1f}M bytes -> "
                f"{'hybrid' if split is not None else 'blocked'}"
            )
        if split is not None:
            log(f"  hybrid split: {cand.summary()} (cover {dense_cover:.0%})")

    b_dev = jnp.asarray(b)
    c_dev = jnp.asarray(c)

    ro = (reorder_cols, False)  # winner's (reorder_cols, reorder_rows)
    race_log = []  # per-candidate measured times of the LAST race that ran
    t0 = time.perf_counter()
    budget = device_budget_bytes()

    def _race_secs(plan_x):
        """Escalating measured time for one candidate (shared by the
        blocked race below and the hybrid-vs-blocked check)."""
        times_x = 8
        secs_x = time_repeat(plan_x, b_dev, alpha, beta, c_dev, times=times_x)
        while secs_x * times_x < 0.35 and times_x < 4096:
            times_x = min(4096, max(times_x * 8, int(0.4 / max(secs_x, 1e-7))))
            secs_x = time_repeat(
                plan_x, b_dev, alpha, beta, c_dev, times=times_x
            )
        return secs_x

    def _race_blocked(cands_r, limit=None, force_time=False):
        """Pack + compile + measured-race single-engine candidates; returns
        (plan, packed, cfg, fmt, ro, best_secs) for the fastest runnable
        one. ``limit`` caps the pack budget on huge rows while keeping
        family diversity (the model's first pick per family survives the
        prune, then ranking order fills the rest). ``force_time`` times
        even a single candidate (the hybrid-vs-blocked comparison needs a
        number). Raises the last error if nothing runs."""
        if limit is not None and len(cands_r) > limit:
            seen_f, pruned = set(), []
            for cand in cands_r:
                if cand[1] not in seen_f:
                    pruned.append(cand)
                    seen_f.add(cand[1])
            for cand in cands_r:
                if len(pruned) >= limit:
                    break
                if cand not in pruned:
                    pruned.append(cand)
            cands_r = pruned[:limit]
        do_race_r = force_time or len(cands_r) > 1
        # Race the whole-B-gather family FIRST: an ELL candidate's working
        # set is b + c + out + carry over the full (K, N)/(M_pad, N)
        # extents; running it while the device is emptiest keeps the peak
        # at max-over-time instead of sum.
        cands_r = sorted(
            cands_r, key=lambda cand: 0 if cand[1] == "ell" else 1
        )
        best = None  # (plan, packed, cfg, fmt, ro, secs)
        last_err_r = None
        any_gated = False
        race_log.clear()
        plan_i = None
        for cfg_i, fmt_i, ro_i in cands_r:
            if fmt_i != "vpu" and backend == "xla":
                continue
            packed_i = None
            try:
                if pack_cache is not None:
                    packed_i = pack_cache.get_or_pack(
                        name, coo, cfg_i, fmt_i, ro_i[0],
                        reorder_rows=ro_i[1],
                    )
                else:
                    packed_i = _pack_for(coo, cfg_i, fmt_i, ro_i[0],
                                         reorder_rows=ro_i[1])
                # Device-footprint gate: resident b_dev/c_dev + the jit's
                # padded b/c/out transients + the pack upload must fit the
                # device; an over-budget candidate is a guaranteed
                # RESOURCE_EXHAUSTED — skip it up front.
                est_i = _est_exec_bytes(packed_i, n, m, k)
                if est_i > budget:
                    log(f"  candidate {fmt_i} bk={cfg_i.block_k} "
                        f"tm={cfg_i.tile_m} wk={cfg_i.window_k}: skipped, "
                        f"est device footprint {est_i / 2**30:.1f} GiB > "
                        f"budget {budget / 2**30:.1f} GiB")
                    race_log.append({
                        "fmt": fmt_i,
                        "skipped": f"footprint {est_i / 2**30:.1f} GiB",
                    })
                    any_gated = True
                    if packed_i is not None and (
                        best is None or packed_i is not best[1]
                    ):
                        packed_i.__dict__.pop("_dev_cache", None)
                    continue
                plan_i = SpmmPlan(
                    packed_i, n,
                    backend=backend
                    if backend not in ("mxu", "edge", "hybrid", "auto")
                    else "auto",
                )
                plan_i(b_dev, alpha, beta, c_dev)  # compile + first run
                if do_race_r:
                    # adaptive repeat count (_race_secs): escalate until
                    # the chain spans well past the dispatch overhead
                    secs_i = _race_secs(plan_i)
                    log(f"  candidate {fmt_i} bk={cfg_i.block_k} "
                        f"tm={cfg_i.tile_m} wk={cfg_i.window_k}: "
                        f"{secs_i * 1e3:.3f} ms")
                    race_log.append(
                        {"fmt": fmt_i, "ms": round(secs_i * 1e3, 3)}
                    )
                else:
                    secs_i = 0.0
                if best is None or secs_i < best[5]:
                    if best is not None:
                        # dethroned candidate: release its device upload —
                        # packed objects live on in pack_cache._mem, and a
                        # race over 1M-row candidates otherwise accumulates
                        # every loser's multi-GB arrays on the device
                        best[1].__dict__.pop("_dev_cache", None)
                    best = (plan_i, packed_i, cfg_i, fmt_i, ro_i, secs_i)
                elif packed_i is not best[1]:
                    packed_i.__dict__.pop("_dev_cache", None)
                if not do_race_r:
                    break
            except Exception as e:  # deterministic compile rejection → next
                msg = f"{type(e).__name__}: {str(e)[:300]}"
                race_log.append({"fmt": fmt_i, "error": msg[:120]})
                log(f"  candidate {fmt_i} bk={cfg_i.block_k} tm={cfg_i.tile_m} "
                    f"wk={cfg_i.window_k} failed: {msg[:120]}")
                # Sanitize before keeping: the raw exception's traceback
                # frames reference the failing call's device arrays (the
                # plan's _dev upload tuple), so storing it would pin them
                # on the device for the rest of the race.
                last_err_r = RuntimeError(msg)
                del e
                plan_i = None  # drop the failed plan's _dev tuple
                # failed candidate may still hold device buffers
                if packed_i is not None and (
                    best is None or packed_i is not best[1]
                ):
                    packed_i.__dict__.pop("_dev_cache", None)
        if best is None:
            if last_err_r is None and any_gated:
                raise _AllGated(
                    "every candidate exceeded the device-memory budget"
                )
            raise last_err_r if last_err_r else RuntimeError("no candidate ran")
        return best

    if split is not None:
        from sextans_tpu.ops.hybrid import HybridSpmmPlan

        plan = HybridSpmmPlan(
            split, n,
            backend="auto",
            residue_config=cfg if stored_hybrid_fmt else None,
            residue_fmt=stored_hybrid_fmt,
            pack_cache=pack_cache,
            cache_name=f"{name}@n{n}-residue",
        )
        fmt = f"hybrid+{plan.residue_fmt}"
        cfg = plan.residue_config
        packed = plan._residue_plan.packed
        # The hybrid gate is a MODEL decision; validate it with a measured
        # race against the best single-engine candidate (analytic models
        # mis-rank 10-100x on some patterns — same reason the blocked race
        # exists). Stored-hybrid rows skip this like every stored config.
        if (
            use_autotune and stored is None
            and backend in ("auto", "hybrid")
        ):
            t_h = None
            hybrid_note = None
            # Footprint-gate the hybrid attempt BEFORE dispatching it: a
            # device OOM can leave the client unusable, so an over-budget
            # hybrid would take every blocked candidate after it down too.
            # The estimate is the residue plan's exec footprint plus the
            # dense component uploads.
            est_h = _est_exec_bytes(packed, n, m, k) + sum(
                int(a.nbytes) for a in getattr(plan, "_dev", {}).values()
            )
            if est_h > budget:
                log(f"  hybrid skipped: est device footprint "
                    f"{est_h / 2**30:.1f} GiB > budget "
                    f"{budget / 2**30:.1f} GiB; "
                    f"racing blocked candidates")
                hybrid_note = f"skipped: footprint {est_h / 2**30:.1f} GiB"
                _release_hybrid_dev(plan, packed)
            else:
                try:
                    plan(b_dev, alpha, beta, c_dev)  # compile hybrid
                    t_h = _race_secs(plan)
                except Exception as e:
                    # A hybrid plan that cannot compile/time must not keep
                    # the row: fall through to the blocked race; any
                    # runnable candidate beats an untimeable hybrid.
                    log(f"  hybrid compile/time failed "
                        f"({type(e).__name__}: {str(e)[:90]}); "
                        f"racing blocked candidates")
                    hybrid_note = "untimeable"
                    _release_hybrid_dev(plan, packed)
            try:
                # Race hybrid against the FULL single-engine candidate
                # list, not the model's top-1 (the model's mis-ranking is
                # exactly why measured races exist).
                cands_h = candidate_list(
                    coo_for_tuning, coo, n, (reorder_cols, False)
                )
                # >8M-nnz rows: same budgeted family-diverse top-3 as the
                # blocked path
                (plan_a, packed_a, cfg_a, fmt_a, ro_a, t_a) = _race_blocked(
                    cands_h, force_time=True,
                    limit=None if coo.nnz <= 8_000_000 else 3,
                )
                if t_h is not None:
                    log(f"  hybrid race: hybrid {t_h * 1e3:.3f} ms vs best "
                        f"blocked {fmt_a} {t_a * 1e3:.3f} ms")
                    race_log.insert(
                        0, {"fmt": "hybrid", "ms": round(t_h * 1e3, 3)}
                    )
                else:
                    race_log.insert(
                        0, {"fmt": "hybrid", "error": hybrid_note}
                    )
                if t_h is None or t_a < t_h:
                    plan, packed = plan_a, packed_a
                    cfg, fmt, ro = cfg_a, fmt_a, ro_a
                    split = None
            except Exception as e:
                log(f"  hybrid race alt failed: {str(e)[:100]}")
                if t_h is None:
                    # neither the hybrid nor any blocked candidate ran
                    raise RuntimeError(
                        f"hybrid untimeable and blocked race failed: "
                        f"{type(e).__name__}: {str(e)[:300]}"
                    ) from None
    else:
        # Candidate race: analytic models mis-rank on some pattern/config
        # combos, and a config can also fail at first compile. Race the top
        # analytic candidates across formats with a short measured timing
        # and keep the fastest runnable one.
        base_ro = (reorder_cols, False)
        if stored is not None or not use_autotune:
            stored_ro = base_ro
            if stored is not None and store is not None:
                meta0 = store.meta(key) or {}
                if meta0.get("reorder2d"):
                    stored_ro = (True, True)
            cands = [(cfg, fmt, stored_ro)]
        else:
            cands = candidate_list(
                coo_for_tuning, coo, n, base_ro, first=(cfg, fmt)
            )
        # Huge matrices: packing each race candidate costs minutes and
        # gigabytes, so race a family-diverse top-3.
        limit = None if coo.nnz <= 8_000_000 else 3
        try:
            plan, packed, cfg, fmt, ro, best_secs = _race_blocked(
                cands, limit=limit
            )
        except _AllGated:
            if len(cands) > 1:
                raise
            # A stored winner (tuned at a smaller N) can be over-budget at
            # this N: rebuild the full candidate list and let the footprint
            # gate pick among families that fit.
            log("  stored candidate over device budget; racing full list")
            cands = candidate_list(coo_for_tuning, coo, n, base_ro)
            limit = None if coo.nnz <= 8_000_000 else 3
            plan, packed, cfg, fmt, ro, best_secs = _race_blocked(
                cands, limit=limit
            )
    t_pack = time.perf_counter() - t0

    rec = {
        "matrix": name,
        "m": m,
        "k": k,
        "nnz": coo.nnz,
        "n": n,
        "fmt": fmt,
        "backend": getattr(plan, "backend", "hybrid"),
        "block_k": cfg.block_k,
        "tile_m": cfg.tile_m,
        "window_k": cfg.window_k,
        "block_fill": round(packed.stats.block_fill, 4),
        "a_bytes_per_nnz": round(packed.stats.bytes_per_nnz, 1),
        "pack_s": round(t_pack, 3),
    }
    if race_log:
        # measured race provenance: every family that ran (or failed) in
        # the race that decided this row, with its candidate time
        rec["race"] = list(race_log)
    if split is None and (ro[0] or ro[1]):
        rec["reorder"] = "2d" if ro[1] else "cols"
    if split is not None:
        rec["hybrid"] = {
            "diags": int(split.diag_offsets.size),
            "diag_nnz": split.diag_nnz,
            "head_cols": int(split.head_cols.size),
            "head_nnz": split.head_nnz,
            "head_rows": int(split.head_rows.size),
            "head_row_nnz": split.head_row_nnz,
            "residue_nnz": split.residue.nnz,
        }

    if verify_gate:
        got_dev = plan(b_dev, alpha, beta, c_dev)
        csr = CSRMatrix.from_coo(coo)
        # One oracle run per row: the f64-exact result serves both the
        # reference tolerance gate (f32-vs-f64 oracle skew ~1e-7 rel, far
        # inside the 1e-4 gate) and the 1e-6 max-abs north star — the f32
        # golden would double the dominant per-row host cost at 1M-row
        # scale for no information.
        if m * n * 4 > VERIFY_SAMPLE_BYTES:
            # Sampled verification for huge outputs: fetching the full C
            # plus the full-matrix f64 oracle on the host costs minutes per
            # row. Verify a deterministic stratified sample of row blocks
            # instead (the device check below covers every element):
            # verify_rows on the record marks the row as sample-verified.
            blocks = _verify_sample_blocks(m)
            rows_s = np.concatenate(
                [np.arange(s, e, dtype=np.int64) for s, e in blocks])

            def _fetch(out):
                # single device-side gather + one small transfer (a
                # per-block lax.slice would compile 64 distinct programs)
                if isinstance(out, np.ndarray):
                    return out[rows_s]
                import jax.numpy as jnp

                return np.asarray(
                    jnp.take(out, jnp.asarray(rows_s, dtype=jnp.int32),
                             axis=0))

            t_v = time.perf_counter()
            got = _fetch(got_dev)
            # restrict the oracle to the columns the sampled rows touch:
            # converting the full (K, N) B to f64 costs gigabytes of
            # allocation on rows this size for entries the sliced A never
            # reads
            sub = _csr_take_rows(csr, rows_s)
            touched = np.unique(sub.indices)
            from sextans_tpu.format.csr import CSRMatrix as _CSR

            sub = _CSR(
                (sub.shape[0], int(touched.size)), sub.indptr,
                np.searchsorted(touched, sub.indices).astype(np.int32),
                sub.vals,
            )
            exact = golden_spmm_exact(
                sub, b[touched], alpha, beta, c[rows_s])
            rec["verify_rows"] = int(rows_s.size)
            log(f"  verify: sampled {len(blocks)} blocks / {rows_s.size} "
                f"rows ({m * n * 4 / 1e6:.0f} MB full C) in "
                f"{time.perf_counter() - t_v:.1f}s")
        else:
            def _fetch(out):
                return np.asarray(out)

            got = _fetch(got_dev)
            exact = golden_spmm_exact(csr, b, alpha, beta, c)
        res = verify(exact.astype(np.float32), got)
        rec["verify"] = "pass" if res.passed else "FAIL"
        rec["max_abs_err"] = float(res.max_abs_err)
        rec["max_abs_vs_f64"] = float(np.abs(got - exact).max())
        if "verify_rows" in rec:
            # FULL-matrix guarantee for huge rows (reference checks every
            # element, sextans-host.cpp:262-290): re-derive every C element
            # on device against the f64 oracle and fetch only the block
            # maxima — upgrades the sampled max_abs_vs_f64 to the exact
            # full-matrix figure; if the runtime rejects float64, keep the
            # sampled verdict and record why.
            try:
                from sextans_tpu.utils.device_verify import device_full_check

                t_fv = time.perf_counter()
                # pass the kernel's own device B — no duplicate upload
                fv = device_full_check(got_dev, csr, b_dev, alpha, beta, c)
                rec["max_abs_vs_f64"] = max(
                    rec["max_abs_vs_f64"], fv["max_abs_vs_f64"]
                )
                rec["verify_full_device"] = True
                exact_cmax = fv["c_max_abs"]
                log(f"  verify: device full-matrix max_abs "
                    f"{fv['max_abs_vs_f64']:.2e} over {fv['blocks']} blocks "
                    f"in {time.perf_counter() - t_fv:.1f}s")
            except Exception as e:
                rec["verify_full_device"] = f"unavailable:{str(e)[:60]}"
                exact_cmax = None
                log(f"  device full verify unavailable: {str(e)[:100]}")
        else:
            exact_cmax = None
        rec["meets_1e6_gate"] = bool(rec["max_abs_vs_f64"] <= 1e-6)
        # release the verification output buffer NOW — the precise-mode
        # attempt and the timing chain below each need their own full-C
        # working set
        got_dev = None
        # ulp-normalized error (docs/ACCURACY.md): f32 cannot represent the
        # result closer than ulp(max|C|)/2, so the honest accuracy column is
        # max_abs in ulps of max|C| — carried on every canonical row.
        cmax = (
            exact_cmax
            if exact_cmax is not None
            else float(np.abs(exact).max())
        )
        ulp = float(np.spacing(np.float32(cmax))) or 1e-45
        rec["c_max_abs"] = round(cmax, 3)
        rec["max_abs_vs_f64_ulp"] = round(rec["max_abs_vs_f64"] / ulp, 2)
        # The literal 1e-6 gate is structurally reachable only when
        # ulp(max|C|) <= 2e-6 (max|C| <~ 16). When it is reachable but the
        # fast engine misses it, run the measured precise sample
        # (benchmarks/precise_verify.py): the float64-accumulating twin of
        # the winning plan is run, verified, and timed — the gate rides the
        # sample; the row's HEADLINE timing below stays the fast engine's.
        if not rec["meets_1e6_gate"] and ulp > 2e-6:
            # No f32 kernel can hit the literal 1e-6 max-abs gate when
            # f32 itself cannot represent the result closer than
            # ulp(max|C|)/2 > 1e-6 — stamp the row with the evidence
            # (c_max_abs + the ulp column above) instead of a silent false.
            rec["gate_unreachable"] = True
        elif not rec["meets_1e6_gate"] and not cfg.precise:
            from benchmarks.precise_verify import attempt_precise_gate

            try:
                upd = attempt_precise_gate(
                    plan=plan, packed=packed, cfg=cfg, split=split, n=n,
                    name=name, coo=coo, csr=csr,
                    b_dev=b_dev, c_dev=c_dev, alpha=alpha, beta=beta,
                    exact=exact, fetch=_fetch, ulp=ulp,
                    full_device="verify_rows" in rec, c_host=c,
                    pack_cache=pack_cache,
                )
                rec.update(upd)
                if rec["meets_1e6_gate"]:
                    log(f"  precise gate banked: "
                        f"{rec['precise_sample']['max_abs_vs_f64']:.2e} "
                        f"<= 1e-6 (level "
                        f"{rec['precise_sample']['level']})")
            except Exception as e:
                rec["gate_note"] = f"precise-failed:{str(e)[:60]}"
                log(f"  precise-mode attempt failed: {str(e)[:100]}")
        if not res.passed:
            log(f"  !! verification failed: {res}")
            return rec
        del got

    # Adaptive repeat count: start at rp_time and escalate until the
    # measured span is ~0.3 s of engine time.
    def measure():
        # In-device repeat chain first; if its while-loop program cannot
        # compile, fall back to the host-chained protocol — same data
        # dependency, can only overestimate, and the row lands instead of
        # erroring.
        from sextans_tpu.utils.timing import time_repeat_chained

        timer = time_repeat
        times = rp_time
        try:
            secs, tinfo = timer(
                plan, b_dev, alpha, beta, c_dev, times=times, detail=True
            )
        except Exception as e:
            log(f"  repeat-chain timing failed "
                f"({type(e).__name__}: {str(e)[:90]}); "
                f"falling back to host-chained timing")
            timer = time_repeat_chained
            secs, tinfo = timer(
                plan, b_dev, alpha, beta, c_dev, times=times, detail=True
            )
        while secs * times < 0.3 and times < 4096:
            times = min(4096, max(times * 4, int(0.35 / max(secs, 1e-6))))
            secs, tinfo = timer(
                plan, b_dev, alpha, beta, c_dev, times=times, detail=True
            )
        return times, secs, tinfo

    times, secs, rec["timing"] = measure()
    rec["rp_time"] = times
    rec["ms"] = round(secs * 1e3, 3)
    rec["gflops"] = round(gflops(coo.nnz, m, n, secs), 2)
    if store is not None and stored is None:
        store.put(key, cfg, fmt=fmt, gflops=rec["gflops"],
                  backend=rec["backend"],
                  reorder2d=bool(split is None and ro[1]),
                  race=list(race_log) or None)
    return rec


def load_covered(path) -> set:
    """(matrix, n) pairs with a measured timing in a results file — the rows
    a coverage-first pass may skip. Unreadable/absent file means nothing is
    covered (run everything)."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return set()
    return {
        (r["matrix"], r["n"])
        for r in doc.get("results", [])
        if "gflops" in r and "error" not in r
    }


def load_failed(path) -> set:
    """(matrix, n) pairs whose canonical row is an error record — rows that
    were attempted and failed in every pass so far."""
    try:
        doc = json.loads(Path(path).read_text())
    except (OSError, json.JSONDecodeError):
        return set()
    return {
        (r["matrix"], r["n"])
        for r in doc.get("results", [])
        if "error" in r and "matrix" in r and "n" in r
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="small", choices=["small", "full"])
    ap.add_argument("--n", type=int, nargs="+", default=[16, 128, 512])
    ap.add_argument("--backend", default="auto")
    ap.add_argument("--autotune", action="store_true")
    ap.add_argument("--reorder-cols", action="store_true")
    ap.add_argument("--rp-time", type=int, default=10)
    ap.add_argument("--deadline-ts", type=float, default=None,
                    help="unix timestamp: stop cleanly before the next row "
                         "once reached (no mid-dispatch kill needed)")
    ap.add_argument("--no-verify", action="store_true")
    ap.add_argument("--force-race", action="store_true",
                    help="ignore stored tuned-config winners and run the "
                         "full measured race (targeted re-race driver)")
    ap.add_argument("--only", default=None, help="substring filter on matrix name")
    ap.add_argument(
        "--skip-covered",
        default=None,
        metavar="RESULTS_JSON",
        help="skip (matrix, N) rows that already have a timing in this "
             "results file (coverage-first budgeting)",
    )
    ap.add_argument("--out", default=None)
    ap.add_argument(
        "--tuned-configs",
        default=None,
        help="JSON config store: reuse stored configs, persist new winners",
    )
    args = ap.parse_args(argv)

    from benchmarks.matrices import suite

    import jax

    from sextans_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    log(f"devices: {jax.devices()}")
    if dev.platform != "gpu":
        log(f"no GPU (platform {dev.platform!r}): the suite measures on the "
            "GPU only")
        return 2

    store = None
    if args.tuned_configs:
        from sextans_tpu.utils.autotune import ConfigStore

        store = ConfigStore(args.tuned_configs)

    session = {
        "timestamp": datetime.now(timezone.utc).isoformat(),
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }

    # Disk-backed pack cache, shared across matrices, N values and
    # candidate races (re-packing 45M-nnz matrices costs minutes per row).
    from sextans_tpu.format.pack_cache import PackCache

    pack_cache = PackCache()

    covered = set()
    failed_prior = set()
    if args.skip_covered:
        covered = load_covered(args.skip_covered)
        failed_prior = load_failed(args.skip_covered)
        log(f"skip-covered: {len(covered)} healthy rows in "
            f"{args.skip_covered}")

    # Never-attempted rows before previously-errored ones: a matrix whose
    # todo rows all failed deterministically in earlier passes must not
    # keep eating the pass budget ahead of rows that were never reached.
    items = list(suite(args.scale).items())
    if failed_prior:
        def _all_failed(entry):
            name_o, _ = entry
            todo_o = [n for n in args.n if (name_o, n) not in covered]
            return 1 if todo_o and all(
                (name_o, n) in failed_prior for n in todo_o
            ) else 0
        items.sort(key=_all_failed)  # stable: keeps suite order within tiers

    results = []
    stopped = False
    for name, gen in items:
        if args.only and args.only not in name:
            continue
        todo_n = [n for n in args.n if (name, n) not in covered]
        if not todo_n:
            log(f"== {name} == all N covered; skipping")
            continue
        if args.deadline_ts and time.time() > args.deadline_ts:
            log("deadline reached; stopping before next matrix")
            stopped = True
            break
        log(f"== {name} ==")
        t0 = time.perf_counter()
        coo = _gen_cached(name, gen)
        log(f"  generated/loaded in {time.perf_counter()-t0:.1f}s: "
            f"{coo.shape} nnz={coo.nnz}")
        for n in todo_n:
            if args.deadline_ts and time.time() > args.deadline_ts:
                log("deadline reached; stopping before next row")
                stopped = True
                break
            try:
                rec = run_one(
                    name, coo, n, args.backend, args.autotune,
                    rp_time=args.rp_time, verify_gate=not args.no_verify,
                    reorder_cols=args.reorder_cols, store=store,
                    pack_cache=pack_cache, force_race=args.force_race,
                )
            except Exception as e:
                log(f"  !! {name} N={n} failed: {e!r}")
                rec = {"matrix": name, "n": n, "error": repr(e)}
            results.append(rec)
            if args.out:  # incremental flush: a killed run keeps its rows
                Path(args.out).write_text(
                    json.dumps({"session": session, "results": results}, indent=1)
                )
            if "RESOURCE_EXHAUSTED" in str(rec.get("error", "")):
                # a device OOM can leave this client unusable for the rest
                # of the process — end the pass cleanly; a fresh run with
                # --skip-covered keeps the finished rows
                log("device OOM: ending this pass (fresh process required)")
                stopped = True
                break
            log(f"  N={n}: {rec.get('gflops', '-')} GFLOPS "
                f"({rec.get('ms', '-')} ms, fmt={rec.get('fmt')}, "
                f"bk={rec.get('block_k')}, fill={rec.get('block_fill')}, "
                f"verify={rec.get('verify', 'skipped')}, "
                f"maxabs_f64={rec.get('max_abs_vs_f64', '-')})")
        if stopped:
            break

    doc = {"session": session, "results": results}
    print(json.dumps(doc, indent=1))
    if args.out:
        Path(args.out).write_text(json.dumps(doc, indent=1))
    bad = [r for r in results if r.get("verify") == "FAIL" or "error" in r]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
