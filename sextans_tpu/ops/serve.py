"""Shape-generic serving: one compiled kernel serves a family of matrices.

The reference serves *arbitrary* A/B/C sizes at runtime with one compiled
bitstream — NUM_ITE/M/P_N/K are kernel ARGUMENTS (src/sextans.h:20-26;
README.md:4 "no need to re-compile... for different input matrices").
Under XLA every shape is a fresh compilation, so a naive port pays 20-40 s
of compile per new matrix. This module restores the reference's property
the XLA way: **shape bucketing**.

All engine entry points (ops/engines.py) are module-level ``jax.jit``
functions whose cache keys are (operand shapes, static knobs). A pack padded to canonical *bucket* dimensions — group count,
M-tile count, K-window count rounded up a geometric series — therefore
hits the SAME compiled executable as every other matrix in its bucket.
B and C are padded on the host (a memcpy, no compile), and the padded
output is sliced on the host after fetch. The group padding extends the
last real group's m-tile run with zero-valued blocks (the same
SPMD-uniformity machinery as multi-chip stacking,
parallel/partition._pad_shard_groups), so padded work contributes exact
zeros. The first matrix of a bucket pays the one-time compile; a second,
previously unseen matrix in the same bucket is served with zero recompiles
(tests/test_serve.py counts them; chip_smoke.py does so on the GPU).

Bucket overhead: padded groups are real (zero-valued) kernel work — the
geometric growth factor bounds it at <= ``growth - 1`` (default 25%) of
the A-stream; padded M-tiles/K-windows add only zero C/B traffic.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from sextans_tpu.format.pack import PackedSpMatrix, pack
from sextans_tpu.format.pack_edge import PackedSpMatrixEdge, pack_edge
from sextans_tpu.format.pack_ell import PackedSpMatrixELL, pack_ell
from sextans_tpu.format.pack_mxu import pack_mxu
from sextans_tpu.ops.engines import (
    device_arrays,
    precision_scope,
    resolve_backend,
    run_padded,
    scalar_f32,
)
from sextans_tpu.utils.config import SpmmConfig, cdiv, round_up

__all__ = ["SpmmServer", "ServePlan", "bucketize_pack", "bucket_up"]


def bucket_up(x: int, growth: float = 1.25) -> int:
    """Smallest member >= x of the geometric bucket series 1, 2, 3, 4, 5,
    7, 9, ... (each step the previous rounded up by ``growth``)."""
    b = 1
    while b < x:
        b = max(b + 1, int(np.ceil(b * growth)))
    return b


def _bucketize_ell(packed: PackedSpMatrixELL, growth: float):
    """Pad an ELL pack so every shape the engine jit keys on sits on the
    bucket series: slots R, the real-row region (m_base), the virtual-row
    count, total padded rows, and the gather space K. All padding
    contributes exact zeros: pad slots compute 0 * B[0, :], pad rows are
    all-zero slots, and pad virtual rows fold 0.0 into the last real fold
    target (repeating it keeps ``fold_rows`` ascending — the engine's
    scatter-add declares ``indices_are_sorted``)."""
    cfg = packed.config
    m_block = cfg.tile_m
    r = packed.slots_per_row
    n_virt = packed.n_virt
    r_b = bucket_up(r, growth)
    m_base_b = round_up(bucket_up(packed.m_base, growth), 8)
    n_virt_b = bucket_up(n_virt, growth) if n_virt else 0
    blocks_b = bucket_up(cdiv(m_base_b + n_virt_b, m_block), growth)
    m_padded_b = blocks_b * m_block
    cols = np.zeros((m_padded_b, r_b), np.int32)
    vals = np.zeros((m_padded_b, r_b), np.float32)
    cols[: packed.m_base, :r] = packed.cols[: packed.m_base]
    vals[: packed.m_base, :r] = packed.vals[: packed.m_base]
    fold = np.zeros(n_virt_b, np.int32)
    if n_virt:
        cols[m_base_b : m_base_b + n_virt, :r] = packed.cols[
            packed.m_base : packed.m_base + n_virt
        ]
        vals[m_base_b : m_base_b + n_virt, :r] = packed.vals[
            packed.m_base : packed.m_base + n_virt
        ]
        fold[:n_virt] = packed.fold_rows
        fold[n_virt:] = packed.fold_rows[-1]
    out = dataclasses.replace(
        packed, cols=cols, vals=vals, fold_rows=fold,
        slots_per_row=r_b, m_base=m_base_b,
    )
    # K only enters the kernel through B's gather-space extent; serve pads
    # B rows to this bucket (gathered indices stay < k, so pad rows are
    # never read with nonzero weight)
    out.__dict__["k_bucket"] = bucket_up(packed.k, growth)
    return out


def bucketize_pack(packed, growth: float = 1.25):
    """Pad a packed matrix to canonical bucket dimensions.

    Returns a pack whose (ngroups, n_mtiles, n_kwins) are bucket values —
    the full shape signature the kernel jit keys on — with zero-valued
    padding groups extending the last real group's m-tile run. ELL packs
    bucket on (R, m_base, n_virt, row blocks, K) instead — see
    :func:`_bucketize_ell`.
    """
    from sextans_tpu.parallel.partition import _pad_shard_groups

    if isinstance(packed, PackedSpMatrixELL):
        return _bucketize_ell(packed, growth)
    if isinstance(packed, PackedSpMatrixEdge):
        n_units = packed.n_chunks
    else:
        n_units = packed.n_groups
    target_units = bucket_up(n_units, growth)
    target_mtiles = bucket_up(packed.n_mtiles, growth)
    target_kwins = bucket_up(packed.n_kwins, growth)
    out = _pad_shard_groups(packed, target_units)
    if (
        target_mtiles != packed.n_mtiles
        or target_kwins != packed.n_kwins
        or out is packed
    ):
        out = dataclasses.replace(
            out, n_mtiles=target_mtiles, n_kwins=target_kwins
        )
    return out


class ServePlan:
    """Executor for one served matrix; shares compiled engines bucket-wide.

    Unlike :class:`~sextans_tpu.ops.plan.SpmmPlan` (which jit-compiles a
    per-instance pad→engine→slice wrapper), a ServePlan pads B/C on the
    HOST and invokes the module-level engine jit directly, so its device
    program is exactly the bucket's shared executable.
    """

    def __init__(self, packed, n: int, backend: str):
        # ServePlan feeds B/C to the engine untouched (the bucket's shared
        # executable has no per-matrix gather). A degree-reordered pack
        # (pack(..., reorder_cols=True)) needs B[col_perm] / C[row_perm]
        # plumbing that only SpmmPlan implements — reject it loudly instead
        # of serving silently wrong values.
        for perm in ("col_perm", "row_perm"):
            if getattr(packed, perm, None) is not None:
                raise ValueError(
                    f"ServePlan does not support reordered packs "
                    f"(packed.{perm} is set); pack without reorder_cols/"
                    f"reorder_rows for serving, or use SpmmPlan"
                )
        self.packed = packed
        self.backend = backend
        self.m, self.k = packed.shape
        self.n = n
        self.m_padded = packed.m_padded
        # ELL buckets K too (k_bucket stamped by _bucketize_ell): B pads to
        # the bucketed gather space so the engine jit never sees a raw K
        self.k_padded = getattr(packed, "k_bucket", packed.k_padded)
        self._dev = device_arrays(packed)

    def _pad_host(self, b, c):
        bp = np.zeros((self.k_padded, self.n), np.float32)
        bp[: self.k] = b
        cp = np.zeros((self.m_padded, self.n), np.float32)
        if c is not None:
            cp[: self.m] = c
        return bp, cp

    def call_padded(self, b_padded, c_padded, alpha, beta):
        """Raw bucket-shaped call: (k_padded, n) B and (m_padded, n) C in,
        padded output device array out."""
        cfg = self.packed.config
        with precision_scope(cfg.precise):
            return run_padded(
                self.backend, cfg, self._dev, b_padded, c_padded,
                scalar_f32(alpha), scalar_f32(beta),
                m_base=getattr(self.packed, "m_base", 0),
            )

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> np.ndarray:
        b = np.asarray(b, dtype=np.float32)
        if b.shape != (self.k, self.n):
            raise ValueError(f"B must be ({self.k}, {self.n}), got {b.shape}")
        if c is None and float(beta) != 0.0:
            raise ValueError("beta != 0 requires an input C")
        if c is not None:
            c = np.asarray(c, dtype=np.float32)
            if c.shape != (self.m, self.n):
                raise ValueError(
                    f"C must be ({self.m}, {self.n}), got {c.shape}"
                )
        bp, cp = self._pad_host(b, c)
        out = self.call_padded(bp, cp, alpha, beta)
        return np.asarray(out)[: self.m]


class SpmmServer:
    """Bucketed multi-matrix SpMM service — the "one bitstream" analog.

    Fixes (N, tiling config, engine) once, like the reference fixes its
    architecture at synthesis; then ``plan(coo)`` serves ANY matrix:
    matrices landing in an already-compiled bucket run with zero
    recompile. See module docstring for the mechanism.
    """

    def __init__(
        self,
        n: int,
        *,
        config: SpmmConfig = SpmmConfig(),
        fmt: str = "vpu",
        backend: str = "auto",
        growth: float = 1.25,
        pack_cache=None,
    ):
        self.backend = resolve_backend(fmt, backend, precise=config.precise)
        self.n = n
        self.config = config
        self.fmt = fmt
        self.growth = growth
        self.pack_cache = pack_cache
        self._buckets: set = set()

    def bucket_signature(self, packed) -> tuple:
        """The full jit-cache key surrogate for a bucketized pack."""
        if isinstance(packed, PackedSpMatrixELL):
            return (
                packed.m_padded,
                packed.slots_per_row,
                packed.n_virt,
                packed.m_base,
                getattr(packed, "k_bucket", packed.k),
                self.backend,
            )
        return (
            packed.n_groups
            if not isinstance(packed, PackedSpMatrixEdge)
            else packed.n_chunks,
            packed.n_mtiles,
            packed.n_kwins,
            self.backend,
        )

    def plan(self, coo, name: Optional[str] = None) -> ServePlan:
        """Pack (cached if a pack_cache/name is given), bucket-pad, and
        return the ServePlan. ``plan.bucket_new`` says whether this bucket
        was seen before by THIS server (a warm bucket implies a warm jit
        cache process-wide)."""
        if self.pack_cache is not None and name is not None:
            packed = self.pack_cache.get_or_pack(
                name, coo, self.config, self.fmt, False
            )
        elif self.fmt == "mxu":
            packed = pack_mxu(coo, self.config)
        elif self.fmt == "edge":
            packed = pack_edge(coo, self.config)
        elif self.fmt == "ell":
            packed = pack_ell(coo, self.config)
        else:
            packed = pack(coo, self.config)
        bucketed = bucketize_pack(packed, self.growth)
        sig = self.bucket_signature(bucketed)
        p = ServePlan(bucketed, self.n, self.backend)
        p.bucket_new = sig not in self._buckets
        self._buckets.add(sig)
        return p
