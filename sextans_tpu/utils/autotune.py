"""Autotuner: pick the pack format and its parameters per sparsity pattern.

The reference fixes its architecture at bitstream-build time
(src/sextans.h:7-15) and eats load imbalance as scheduler bubbles
(src/sparse_helper.h:390-400). Here the equivalent knobs are runtime
parameters, so we pick them per matrix:

* **analytic mode** (:func:`choose_backend` and the per-format choosers) —
  exact block counts for each candidate geometry from one O(nnz) pass each
  (no packing), ranked by the bytes the format's engine moves per call
  (``predicted_cost`` is that byte count). No device time and no device
  rates: the engines are bound by memory traffic, so bytes order the
  candidates.
* **measured mode** (:func:`autotune`) — packs the top analytic candidates
  and times the real engine on the device, returning the fastest plan.

Byte model of the plain-XLA block engines (ops/spmm_xla.py), per block of
``rows x bk`` values at width n: the packed values, the gathered B rows
(written and read once: ``2 * bk * 4n``) and the per-block result (written,
read by the scatter, and the accumulator read-modify-write:
``4 * rows * 4n``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.utils.config import SpmmConfig

__all__ = [
    "choose_config",
    "choose_config_mxu",
    "choose_config_edge",
    "choose_config_ell",
    "choose_backend",
    "autotune",
    "block_counts",
    "block_counts_mxu",
    "block_bytes",
    "hybrid_cost",
    "TuneResult",
    "ConfigStore",
]

logger = logging.getLogger("sextans_tpu.autotune")

# Packed-A inflation ceiling for dense-slab candidates (bytes of packed vals
# per nonzero; CSR is ~8): past it the pack is a host-memory and upload
# problem before it is an engine-time one.
MXU_MAX_BYTES_PER_NNZ = 512.0


def block_bytes(n_blocks: int, rows: int, bk: int, n: int) -> float:
    """Bytes one block-engine call moves for ``n_blocks`` blocks of
    ``rows x bk`` values at width ``n`` (module docstring)."""
    per_block = 4.0 * rows * bk + 8.0 + 4.0 * n * (2 * bk + 4 * rows)
    return n_blocks * per_block


def _dense_io_bytes(m: int, n: int) -> float:
    """C read and output write."""
    return 2.0 * m * n * 4


def _tune_cache(coo) -> dict:
    """Per-matrix memo for the O(nnz log nnz) count primitives below: one
    suite row invokes the family choosers several times (top-pick, race
    diversity, hybrid gate), and each np.unique over a 45M-edge matrix
    costs seconds — uncached, ldoor-class rows spent ~20 min in pure
    analytics."""
    c = getattr(coo, "_tune_cache", None)
    if c is None:
        c = {}
        try:
            coo._tune_cache = c
        except AttributeError:
            pass
    return c


def block_counts(
    coo: COOMatrix, block_ks: Sequence[int] = (1, 2, 4, 8, 16)
) -> dict:
    """Exact number of 8 x bk blocks A occupies, for each candidate bk."""
    cache = _tune_cache(coo)
    br = None
    out = {}
    for bk in block_ks:
        key = ("bc8", bk)
        if key not in cache:
            if br is None:
                br = coo.rows.astype(np.int64) >> 3
            bc = coo.cols.astype(np.int64) // bk
            keys = br * ((coo.shape[1] // bk) + 1) + bc
            cache[key] = int(np.unique(keys).size)
        out[bk] = cache[key]
    return out


def job_counts(coo: COOMatrix, tile_m: int, window_k: int) -> int:
    """Exact number of (M-tile, K-window) jobs with nonzeros — each one costs
    one more partly filled group of blocks."""
    cache = _tune_cache(coo)
    key = ("jc", tile_m, window_k)
    if key not in cache:
        mt = coo.rows.astype(np.int64) // tile_m
        kw = coo.cols.astype(np.int64) // window_k
        keys = mt * ((coo.shape[1] // window_k) + 1) + kw
        cache[key] = int(np.unique(keys).size)
    return cache[key]


@dataclass
class TuneResult:
    config: SpmmConfig
    predicted_cost: float
    measured_ms: Optional[float] = None
    # packed format this config targets (ops/engines.py): "vpu", "mxu",
    # "edge" or "ell"
    fmt: str = "vpu"


def choose_config(
    coo: COOMatrix,
    base: SpmmConfig = SpmmConfig(),
    block_ks: Sequence[int] = (1, 2, 4, 8),
    tile_ms: Sequence[int] = (512, 1024, 2048, 4096),
    window_ks: Sequence[int] = (2048, 4096, 8192, 16384),
    top: int = 1,
    n: int = 512,
) -> List[TuneResult]:
    """Analytic config choice for the 8 x block_k block format; best first.

    Cost is :func:`block_bytes` over the padded block count (each job is
    padded to a multiple of ``group_blocks``, modeled as half a group per
    job) plus C in/out. Small bk pads less; large bk gathers each B row for
    fewer per-block results."""
    m = max(coo.shape[0], 1)
    counts = block_counts(coo, block_ks)
    results = []
    for tm, wk in [(a, b) for a in tile_ms for b in window_ks]:
        njobs = job_counts(coo, tm, wk)
        for bk, nb in counts.items():
            # group_blocks: a multiple of 128 // bk (the format's value-lane
            # chunk), sized near the average job, at most 16 chunks
            chunk = max(128 // bk, 1)
            avg_job = max(1, nb // max(njobs, 1))
            gb = chunk
            while gb * 2 <= min(2 * avg_job, 16 * chunk):
                gb *= 2
            cfg = base.with_(block_k=bk, tile_m=tm, window_k=wk,
                             group_blocks=gb)
            padded_blocks = nb + njobs * gb // 2
            cost = block_bytes(padded_blocks, 8, bk, n) + _dense_io_bytes(m, n)
            results.append(TuneResult(cfg, cost))
    results.sort(key=lambda r: r.predicted_cost)
    return results[:top]


def block_counts_mxu(
    coo: COOMatrix, block_ks: Sequence[int] = (32, 64, 128)
) -> dict:
    """Exact number of 128 x bk dense slabs A occupies, per candidate bk."""
    cache = _tune_cache(coo)
    ms = None
    out = {}
    for bk in block_ks:
        key = ("bc128", bk)
        if key not in cache:
            if ms is None:
                ms = coo.rows.astype(np.int64) >> 7  # 128-row slab
            bc = coo.cols.astype(np.int64) // bk
            keys = ms * ((coo.shape[1] // bk) + 1) + bc
            cache[key] = int(np.unique(keys).size)
        out[bk] = cache[key]
    return out


def choose_config_mxu(
    coo: COOMatrix,
    base: SpmmConfig = SpmmConfig(),
    block_ks: Sequence[int] = (32, 64, 128),
    tile_ms: Sequence[int] = (512, 1024, 2048, 4096),
    window_ks: Sequence[int] = (2048, 4096, 8192),
    top: int = 1,
    n: int = 512,
) -> List[TuneResult]:
    """Analytic config choice for the block_k x 128 dense-slab format; best
    first, by :func:`block_bytes` with 128-row blocks.

    Candidates whose packed A would exceed ``MXU_MAX_BYTES_PER_NNZ`` are
    dropped: on scattered patterns the dense-slab format inflates to
    kilobytes per nonzero."""
    m = max(coo.shape[0], 1)
    counts = block_counts_mxu(coo, block_ks)
    results = []
    for tm, wk in [(a, b) for a in tile_ms for b in window_ks]:
        if tm % 128 != 0:
            continue
        njobs = job_counts(coo, tm, wk)
        for bk, nb in counts.items():
            if bk % 8 != 0 or wk % bk != 0:
                continue
            if nb * bk * 128 * 4 > MXU_MAX_BYTES_PER_NNZ * max(coo.nnz, 1):
                continue
            gb = max(1, min(64, 1024 // bk))
            avg_job = max(1, nb // max(njobs, 1))
            while gb > 1 and gb > 2 * avg_job:
                gb //= 2
            cfg = base.with_(
                block_k=bk, tile_m=tm, window_k=wk, group_blocks=gb
            )
            padded_blocks = nb + njobs * gb // 2
            cost = (block_bytes(padded_blocks, 128, bk, n)
                    + _dense_io_bytes(m, n))
            results.append(TuneResult(cfg, cost, fmt="mxu"))
    results.sort(key=lambda r: r.predicted_cost)
    return results[:top]


def choose_config_edge(
    coo: COOMatrix,
    base: SpmmConfig = SpmmConfig(),
    tile_ms: Sequence[int] = (1024, 2048, 4096, 8192, 16384),
    window_ks: Sequence[int] = (4096, 8192, 16384, 32768),
    top: int = 1,
    n: int = 512,
) -> List[TuneResult]:
    """Analytic config choice for the edge format (one 1 x 1 block per
    nonzero, padding only at job-chunk tails); best first. Its cost does
    not depend on the pattern, so it wins where block fill collapses."""
    from sextans_tpu.format.pack_edge import MAX_TILE_M, MAX_WINDOW_K

    m = max(coo.shape[0], 1)
    nnz = max(coo.nnz, 1)
    E = base.edge_chunk
    results = []
    for tm in tile_ms:
        if tm > MAX_TILE_M:
            continue
        for wk in window_ks:
            if wk > MAX_WINDOW_K:
                continue
            njobs = job_counts(coo, tm, wk)
            padded_edges = nnz + njobs * E // 2
            cost = block_bytes(padded_edges, 1, 1, n) + _dense_io_bytes(m, n)
            results.append(
                TuneResult(base.with_(tile_m=tm, window_k=wk), cost,
                           fmt="edge")
            )
    results.sort(key=lambda r: r.predicted_cost)
    return results[:top]


def choose_config_ell(
    coo: COOMatrix,
    base: SpmmConfig = SpmmConfig(),
    tile_ms: Sequence[int] = (512, 8192, 65536),
    top: int = 1,
    n: int = 512,
) -> List[TuneResult]:
    """Analytic config choice for the ELL gather format; best first.

    The slot count comes from the degree histogram
    (:func:`~sextans_tpu.format.pack_ell.choose_slots_per_row`); the cost is
    its gather traffic plus the pad rows that rounding the row count up to
    ``tile_m`` adds. Candidates whose slot inflation would make ``pack_ell``
    refuse are dropped."""
    from sextans_tpu.format.pack_ell import (
        DEFAULT_MAX_BYTES_PER_NNZ,
        ELL_MIN_FETCH,
        choose_slots_per_row,
        ell_traffic_bytes,
    )
    from sextans_tpu.utils.config import round_up

    m = max(coo.shape[0], 1)
    nnz = max(coo.nnz, 1)
    deg = np.bincount(coo.rows, minlength=m).astype(np.int64)
    r = choose_slots_per_row(coo, n=n)
    base_bytes = ell_traffic_bytes(deg, r, n) + m * n * 4.0
    pad_row_bytes = r * (max(4 * n, ELL_MIN_FETCH) + 8.0) + 4.0 * n
    chunks = np.maximum(-(-deg // r), (deg > 0).astype(np.int64))
    virt = int(np.maximum(chunks - 1, 0).sum())
    m_total = m + virt
    results = []
    for tm in tile_ms:
        m_padded = round_up(max(m_total, 1), tm)
        if (
            8.0 * m_padded * r / nnz > DEFAULT_MAX_BYTES_PER_NNZ
            and 8 * m_padded * r > (1 << 20)
        ):
            continue  # pack_ell would refuse this inflation
        cost = base_bytes + (m_padded - m_total) * pad_row_bytes
        results.append(TuneResult(base.with_(tile_m=tm, ell_r=r), cost,
                                  fmt="ell"))
    results.sort(key=lambda t: t.predicted_cost)
    return results[:top]


def choose_backend(
    coo: COOMatrix,
    n: int = 512,
    base: SpmmConfig = SpmmConfig(),
    top: int = 1,
) -> List[TuneResult]:
    """Joint analytic choice across the four packed formats — the
    per-sparsity-pattern dispatch the reference resolves at bitstream-build
    time. Returns the merged top-N, best first; ``TuneResult.fmt`` says
    which pack pass to run."""
    vpu = choose_config(coo, base, top=max(top, 1), n=n)
    mxu = choose_config_mxu(coo, base, top=max(top, 1), n=n)
    edge = choose_config_edge(coo, base, top=max(top, 1), n=n)
    ell = choose_config_ell(coo, base, top=max(top, 1), n=n)
    merged = sorted(vpu + mxu + edge + ell, key=lambda r: r.predicted_cost)
    return merged[:top]


def autotune(
    coo: COOMatrix,
    n: int,
    base: SpmmConfig = SpmmConfig(),
    block_ks: Sequence[int] = (2, 4, 8),
    candidates: int = 3,
    backend: str = "auto",
    rp_time: int = 64,
) -> TuneResult:
    """Measured autotune: time the top analytic candidates on device.

    Candidates span all four formats; ``backend`` applies to block-format
    candidates only ("auto" resolves per format, ops/engines.py).
    """
    import jax.numpy as jnp

    from sextans_tpu.format.pack import pack
    from sextans_tpu.format.pack_edge import pack_edge
    from sextans_tpu.format.pack_mxu import pack_mxu
    from sextans_tpu.ops.plan import SpmmPlan
    from sextans_tpu.utils.timing import time_repeat

    cands = choose_config(coo, base, block_ks, top=candidates, n=n)
    cands += choose_config_mxu(coo, base, top=max(1, candidates - 1), n=n)
    cands += choose_config_edge(coo, base, top=1, n=n)
    cands += choose_config_ell(coo, base, top=1, n=n)
    m, k = coo.shape
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    c0 = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32))

    best: Optional[TuneResult] = None
    errors = []
    for cand in cands:
        try:
            if cand.fmt == "mxu":
                packed = pack_mxu(coo, cand.config)
                plan = SpmmPlan(packed, n, backend="auto")
            elif cand.fmt == "edge":
                packed = pack_edge(coo, cand.config)
                plan = SpmmPlan(packed, n, backend="auto")
            elif cand.fmt == "ell":
                from sextans_tpu.format.pack_ell import pack_ell

                packed = pack_ell(coo, cand.config)
                plan = SpmmPlan(packed, n, backend="auto")
            else:
                packed = pack(coo, cand.config)
                plan = SpmmPlan(packed, n, backend=backend)
            secs = time_repeat(plan, b, 1.0, 0.5, c0, times=rp_time)
        except Exception as e:  # candidate failed to compile/run — skip it,
            # but never silently (a flaky session would otherwise degrade the
            # chosen config with no trace).
            logger.warning("autotune candidate %s failed: %r", cand.config, e)
            errors.append((cand.config, repr(e)))
            continue
        cand.measured_ms = secs * 1e3
        logger.info("autotune candidate %s: %.3f ms", cand.config, cand.measured_ms)
        if best is None or cand.measured_ms < best.measured_ms:
            best = cand
    if best is None:
        raise RuntimeError(
            f"no autotune candidate ran successfully; failures: {errors}"
        )
    return best


def hybrid_cost(split, n: int = 512) -> float:
    """Modeled bytes of one HybridSpmmPlan call: the diagonal values and one
    pass over B for the fused diagonal part, the dense head strips with
    their B rows, and the residue's best format. Comparable with
    ``choose_backend(...)[0].predicted_cost`` for the engage/skip
    decision."""
    m, k = split.m, split.k
    cost = _dense_io_bytes(m, n)
    D = int(split.diag_offsets.size)
    if D:
        cost += D * m * 4.0 + k * n * 4.0
    H = int(split.head_cols.size)
    if H:
        cost += m * H * 4.0 + H * n * 4.0
    R = int(split.head_rows.size)
    if R:
        cost += R * k * 4.0 + k * n * 4.0
    if split.residue.nnz:
        cost += choose_backend(split.residue, n=n)[0].predicted_cost
    return cost


class ConfigStore:
    """Persisted per-workload tuned configs — the analog of the reference's
    prebuilt-bitstream library (TAPAB env, README.md:46-48): tune once,
    reuse the winning configuration across sessions.

    Keys are free-form strings (suite rows use ``"{matrix}|n={n}"``). Values
    carry the full :class:`SpmmConfig` plus optional metadata (measured
    GFLOPS, session id) so published benchmark rows stay reproducible.
    """

    def __init__(self, path):
        self.path = Path(path)
        self._data = {}
        if self.path.exists():
            try:
                self._data = json.loads(self.path.read_text())
            except (json.JSONDecodeError, OSError) as e:
                logger.warning("config store %s unreadable: %r", self.path, e)

    def get(self, key: str) -> Optional[SpmmConfig]:
        rec = self._data.get(key)
        if rec is None:
            return None
        kw = dict(rec["config"])
        return SpmmConfig(**kw)

    def meta(self, key: str) -> Optional[dict]:
        rec = self._data.get(key)
        return None if rec is None else rec.get("meta", {})

    def put(self, key: str, config: SpmmConfig, **meta) -> None:
        self._data[key] = {
            "config": dataclasses.asdict(config),
            "meta": meta,
        }
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(json.dumps(self._data, indent=1, sort_keys=True))
