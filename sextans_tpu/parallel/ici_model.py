"""Per-shard byte model for multi-device SpMM plans.

Single-device autotuning ranks formats by the bytes their engine moves
(utils/autotune.py); this module adds the cross-device terms so sharded
plans can be *chosen* — not just executed — per matrix:

* **row-shard** (ShardedSpmmPlan): C rows are produced where A rows live,
  so the steady-state step has NO in-step collective. The cross-device term
  is the B operand reaching every device: replicated placement moves
  ``(S-1)/S`` of ``K x N x 4`` bytes to each. Compute runs at the SLOWEST
  shard's pace — the per-shard byte count, not the global one, is what
  matters (the ``nnz_imbalance`` ceiling of partition.py).
* **K-shard** (ShardedSpmmPlanK): every device computes a full-M partial
  and ``psum_scatter`` folds them: a reduce-scatter moving
  ``M_padded x N x 4 * (S-1)/S`` bytes per device.

Every device reaches every other at the same rate (NVLink, all to all), so
the model counts bytes and carries no link topology. It is checked
structurally: ``collective_shapes`` extracts every collective op and its
byte count from a compiled sharded step, and tests assert the model's byte
terms equal the compiled program's (tests/test_ici_model.py).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.utils.config import SpmmConfig, round_up

__all__ = [
    "collective_bytes",
    "collective_shapes",
    "choose_sharded_config",
]


def collective_bytes(
    mode: str, n_shards: int, m_padded: int, k_padded: int, n_padded: int
) -> Dict[str, float]:
    """Per-device cross-device bytes of one sharded step, by collective.

    Keys name the collective the compiled step must contain ("" terms are
    placement/ingest costs with no in-step op). Matches what
    ``collective_shapes`` extracts from the compiled HLO.
    """
    s = max(n_shards, 1)
    frac = (s - 1) / s
    if mode == "row":
        return {
            # B replication is a placement-time broadcast, not an in-step
            # collective: the compiled step must contain NO collectives.
            "b_broadcast_ingest": k_padded * n_padded * 4.0 * frac,
        }
    if mode == "col":
        return {
            # psum_scatter lowers to reduce-scatter over the full padded
            # partial-C operand
            "reduce-scatter": m_padded * n_padded * 4.0 * frac,
        }
    raise ValueError(f"unknown shard mode {mode!r}")


def collective_shapes(compiled_text: str) -> List[Dict]:
    """Extract collective ops + f32 element counts from HLO text.

    Returns one entry per collective instruction: ``{"op", "elems",
    "bytes"}``. Used by tests to assert the cost model's byte terms against
    the program XLA actually built for the mesh.
    """
    out = []
    for line in compiled_text.splitlines():
        line = line.strip()
        m = re.match(
            r".*?=\s*f32\[([0-9,]*)\][^ ]*\s+"
            r"(all-gather|all-reduce|reduce-scatter|collective-permute)",
            line,
        )
        if not m:
            continue
        dims = [int(d) for d in m.group(1).split(",") if d]
        elems = int(np.prod(dims)) if dims else 1
        out.append(
            {"op": m.group(2), "elems": elems, "bytes": 4 * elems,
             "shape": tuple(dims)}
        )
    return out


def _shard_row_ranges(m: int, n_shards: int, tile_m: int) -> List[tuple]:
    m_padded = round_up(max(m, 1), n_shards * tile_m)
    m_local = m_padded // n_shards
    return [
        (s * m_local, min((s + 1) * m_local, m)) for s in range(n_shards)
    ]


def _per_shard_best(
    coo: COOMatrix,
    n: int,
    n_shards: int,
    mode: str,
    base: SpmmConfig,
) -> List:
    """Best (fmt, config, predicted bytes) per shard, shard-local stats."""
    from sextans_tpu.utils.autotune import choose_backend

    m, k = coo.shape
    results = []
    if mode == "row":
        ranges = _shard_row_ranges(m, n_shards, base.tile_m)
        order = np.argsort(coo.rows, kind="stable")
        rows_s = coo.rows[order]
        bounds = np.searchsorted(rows_s, [r[0] for r in ranges] + [m])
        for s, (lo, hi) in enumerate(ranges):
            sel = slice(bounds[s], bounds[s + 1])
            local = COOMatrix(
                (max(hi - lo, 1), k),
                rows_s[sel] - lo,
                coo.cols[order][sel],
                coo.vals[order][sel],
            )
            results.append(choose_backend(local, n=n, top=1)[0])
    elif mode == "col":
        k_local = round_up(max(k, 1), n_shards * 128) // n_shards
        order = np.argsort(coo.cols, kind="stable")
        cols_s = coo.cols[order]
        bounds = np.searchsorted(
            cols_s, [s * k_local for s in range(n_shards)] + [k]
        )
        for s in range(n_shards):
            sel = slice(bounds[s], bounds[s + 1])
            local = COOMatrix(
                (m, k_local),
                coo.rows[order][sel],
                cols_s[sel] - s * k_local,
                coo.vals[order][sel],
            )
            results.append(choose_backend(local, n=n, top=1)[0])
    else:
        raise ValueError(f"unknown shard mode {mode!r}")
    return results


def choose_sharded_config(
    coo: COOMatrix,
    n_shards: int,
    n: int = 512,
    mode: str = "row",
    base: SpmmConfig = SpmmConfig(),
) -> Dict:
    """Per-shard-aware (fmt, config) choice for a sharded plan.

    Single-chip logic picks by GLOBAL matrix stats; on a mesh the step
    finishes when the slowest shard does, so the right objective is the
    max over shard-LOCAL predicted costs. All shards must share one
    (fmt, config) — shard_map compiles one program — so this evaluates
    each shard's best family and takes a majority-vote format re-costed
    per shard, reporting the straggler.

    Returns {"fmt", "config", "max_shard_bytes", "per_shard", "votes"}.
    """
    per = _per_shard_best(coo, n, n_shards, mode, base)
    votes: Dict[str, int] = {}
    for t in per:
        votes[t.fmt] = votes.get(t.fmt, 0) + 1
    fmt = max(votes, key=lambda f: votes[f])
    # among shards voting for the winning format, the slowest shard's
    # config choice is the safest shared config (its padding constraints
    # dominate the step time)
    candidates = [t for t in per if t.fmt == fmt]
    worst = max(candidates, key=lambda t: t.predicted_cost)
    return {
        "fmt": fmt,
        "config": worst.config,
        # the step ends when the slowest shard does, whatever its format
        "max_shard_bytes": float(max(t.predicted_cost for t in per)),
        "per_shard": [
            {"fmt": t.fmt, "bytes": float(t.predicted_cost)} for t in per
        ],
        "votes": votes,
    }
