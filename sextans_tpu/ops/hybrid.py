"""Hybrid structure-split SpMM: diagonals + dense head columns + residue.

The reference FPGA is *structure-independent*: its PEs decode an arbitrary
per-edge column every cycle (src/sextans.cpp:388-419), so webgraph-class and
stencil-class matrices run at the same 64 nnz/cycle as FEM matrices. Block
formats lose that property — a power-law or pure-diagonal pattern shatters
into nearly-empty blocks. The answer here is not a gather PE but a
*representation split*: decompose A by structure and give each part the
execution engine it maps onto:

* **Diagonals** (stencil / KKT / banded class): a diagonal ``c`` stores
  ``A[i, i+c]`` as a dense vector; its SpMM contribution is
  ``diag[:, None] * B[i+c, :]`` — a shifted elementwise FMA over (M, N)
  that XLA fuses across diagonals into one loop with zero padding or
  steering. (DIA format, reborn as fused XLA.)
* **Dense head columns** (power-law class): the hub columns — for the
  webgraph generator the top 128 columns carry ~70% of nnz — are lifted
  into a dense (M, H) matrix; their contribution is one dense matmul
  ``head @ B[head_cols]`` at ``Precision.HIGHEST``.
* **Residue**: whatever structure remains goes through the packed formats'
  engines (ops/engines.py), the format picked by the analytic autotuner.

``C = beta*C + alpha*(diag_part + head_part) `` feeds the residue kernel as
its C input with beta=1, so the whole composition is ONE jitted program and
one residue engine call.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.utils.config import SpmmConfig

__all__ = ["HybridSplit", "split_structure", "HybridSpmmPlan",
           "SPLIT_VERSION"]

# Bump when split_structure's selection logic changes: cached splits
# (PackCache.get_or_split) key on this, so stale decompositions can never
# be served after an algorithm change.
SPLIT_VERSION = 3


@dataclass
class HybridSplit:
    """Structure decomposition of a sparse matrix (host-side)."""

    m: int
    k: int
    nnz: int
    # diagonals: offsets c (col - row); vals[d, i] = A[i, i + offsets[d]]
    diag_offsets: np.ndarray  # (D,) int64
    diag_vals: np.ndarray  # (D, m) float32
    # dense head columns (original column ids) and their dense values
    head_cols: np.ndarray  # (H,) int32
    head_dense: np.ndarray  # (m, H) float32
    # dense head rows (hub rows, e.g. circuit power nets): full dense rows
    head_rows: np.ndarray  # (R,) int32
    head_rows_dense: np.ndarray  # (R, k) float32
    residue: COOMatrix

    @property
    def diag_nnz(self) -> int:
        return int(np.count_nonzero(self.diag_vals))

    @property
    def head_nnz(self) -> int:
        return int(np.count_nonzero(self.head_dense))

    @property
    def head_row_nnz(self) -> int:
        return int(np.count_nonzero(self.head_rows_dense))

    def summary(self) -> str:
        return (
            f"HybridSplit(m={self.m}, k={self.k}, nnz={self.nnz}: "
            f"{self.diag_offsets.size} diagonals ({self.diag_nnz}), "
            f"{self.head_cols.size} head cols ({self.head_nnz}), "
            f"{self.head_rows.size} head rows ({self.head_row_nnz}), "
            f"residue {self.residue.nnz})"
        )

    # -- persistence: split_structure costs minutes of host scatter work on
    #    10M+-edge matrices and is re-run per (matrix, N) benchmark row, so
    #    it joins the pack cache (format/pack_cache.py) as a cacheable
    #    preprocessing artifact. The dense planes compress well (they are
    #    mostly zeros: only head/diag entries are populated). --
    def save(self, path) -> None:
        np.savez_compressed(
            Path(path),
            dims=np.array([self.m, self.k, self.nnz], dtype=np.int64),
            diag_offsets=self.diag_offsets,
            diag_vals=self.diag_vals,
            head_cols=self.head_cols,
            head_dense=self.head_dense,
            head_rows=self.head_rows,
            head_rows_dense=self.head_rows_dense,
            residue_rows=self.residue.rows,
            residue_cols=self.residue.cols,
            residue_vals=self.residue.vals,
        )

    @staticmethod
    def load(path) -> "HybridSplit":
        z = np.load(Path(path))
        m, k, nnz = (int(x) for x in z["dims"])
        return HybridSplit(
            m=m,
            k=k,
            nnz=nnz,
            diag_offsets=z["diag_offsets"],
            diag_vals=z["diag_vals"],
            head_cols=z["head_cols"],
            head_dense=z["head_dense"],
            head_rows=z["head_rows"],
            head_rows_dense=z["head_rows_dense"],
            residue=COOMatrix(
                (m, k), z["residue_rows"], z["residue_cols"],
                z["residue_vals"],
            ),
        )


def _residue_bytes_per_nnz(n: int) -> float:
    """Bytes one residue nonzero costs at width n in the cheapest format
    (ELL gather: one B row plus its column/value record)."""
    return 4.0 * n + 8.0


def _cost_based_degree(m_other: int, n: int, length: int) -> int:
    """Break-even degree for lifting one column (or row) of ``length``
    entries into the dense head: lift when its residue bytes exceed the
    dense strip's ``length * 4``."""
    return max(4, int(4.0 * length / _residue_bytes_per_nnz(n)))


def _cost_based_diag(m: int, n: int) -> int:
    """Break-even nonzero count for lifting one diagonal: its dense values
    cost ``m * 4`` bytes, and the shifted B reads of all diagonals fuse into
    one pass."""
    return max(4, int(4.0 * m / _residue_bytes_per_nnz(n)))


def split_structure(
    coo: COOMatrix,
    *,
    n: Optional[int] = None,
    diag_min_density: float = 0.15,
    max_diags: int = 48,
    head_min_degree_frac: float = 0.004,
    max_head_cols: int = 2048,
    min_head_cols: int = 32,
    row_min_degree_frac: float = 0.004,
    max_head_rows: int = 256,
    min_head_rows: int = 8,
) -> HybridSplit:
    """Decompose ``coo`` into diagonals + dense head columns + residue.

    Selection heuristics (cost-motivated):

    * a diagonal is lifted when it holds enough nonzeros: with ``n``
      given, when their residue bytes exceed its dense values' ``m * 4``
      (:func:`_cost_based_diag`); without ``n``, at
      ``diag_min_density * m`` nonzeros;
    * a column is lifted into the head when it pays: with ``n`` given, the
      threshold is the break-even degree at which the column's residue
      bytes (``deg * (4n + 8)``) exceed the dense strip's ``M * 4``
      (:func:`_cost_based_degree`). Without ``n``, the fixed
      ``head_min_degree_frac * m`` rule applies. Either way the head is
      capped at ``max_head_cols`` densest columns (M x H x 4 bytes);
    * everything else is the residue, in ORIGINAL coordinates (no global
      permutation: B is only gathered for the head's H rows).
    """
    m, k = coo.shape
    rows = coo.rows.astype(np.int64)
    cols = coo.cols.astype(np.int64)
    vals = coo.vals
    n_edges = rows.size

    taken = np.zeros(n_edges, dtype=bool)

    # --- diagonals ---
    d = cols - rows  # in [-(m-1), k-1]
    dmin = int(d.min(initial=0))
    counts = np.bincount((d - dmin).astype(np.int64))
    if n is not None:
        thresh = _cost_based_diag(m, n)
        # dvals is (D, m) dense: cap its footprint at ~1.5 GB
        max_diags = min(max(max_diags, 256),
                        max(8, int(1.5e9 / max(4 * m, 1))))
    else:
        thresh = max(1, int(diag_min_density * min(m, k)))
    cand = np.flatnonzero(counts >= thresh)
    order = np.argsort(-counts[cand], kind="stable")
    cand = cand[order[:max_diags]]
    diag_offsets = np.sort(cand + dmin)
    if diag_offsets.size:
        on_diag = np.isin(d, diag_offsets)
        taken |= on_diag
        diag_vals = np.zeros((diag_offsets.size, m), dtype=np.float32)
        off_index = {int(c): i for i, c in enumerate(diag_offsets)}
        dsel = np.flatnonzero(on_diag)
        didx = np.fromiter(
            (off_index[int(x)] for x in d[dsel]), count=dsel.size, dtype=np.int64
        )
        np.add.at(diag_vals, (didx, rows[dsel]), vals[dsel])
    else:
        diag_vals = np.zeros((0, m), dtype=np.float32)

    # --- dense head columns (degree computed on what's left) ---
    rem = ~taken
    deg = np.bincount(cols[rem], minlength=k)
    # absolute floor: a column below ~4 nnz never beats the residue
    if n is not None:
        deg_thresh = _cost_based_degree(k, n, length=m)
    else:
        deg_thresh = max(4, int(head_min_degree_frac * m))
    head_cols = np.flatnonzero(deg >= deg_thresh)
    # memory cap: the dense head costs M x H x 4 bytes on host AND device —
    # bound it at ~1.5 GB so 1M-row matrices cannot blow up under the
    # cost-widened threshold
    max_head_eff = min(max_head_cols, max(min_head_cols,
                                          int(1.5e9 / max(4 * m, 1))))
    if head_cols.size > max_head_eff:
        top = np.argsort(-deg[head_cols], kind="stable")[:max_head_eff]
        head_cols = np.sort(head_cols[top])
    if head_cols.size < min_head_cols:
        head_cols = np.zeros(0, dtype=np.int64)
    if head_cols.size:
        in_head = np.zeros(k, dtype=bool)
        in_head[head_cols] = True
        on_head = rem & in_head[cols]
        taken |= on_head
        col_rank = np.zeros(k, dtype=np.int64)
        col_rank[head_cols] = np.arange(head_cols.size)
        head_dense = np.zeros((m, head_cols.size), dtype=np.float32)
        hsel = np.flatnonzero(on_head)
        np.add.at(head_dense, (rows[hsel], col_rank[cols[hsel]]), vals[hsel])
    else:
        head_dense = np.zeros((m, 0), dtype=np.float32)

    # --- dense head rows (hub rows — circuit nets, supernode rows) ---
    rem = ~taken
    rdeg = np.bincount(rows[rem], minlength=m)
    if n is not None:
        rdeg_thresh = _cost_based_degree(m, n, length=k)
    else:
        rdeg_thresh = max(4, int(row_min_degree_frac * k))
    head_rows = np.flatnonzero(rdeg >= rdeg_thresh)
    if head_rows.size > max_head_rows:
        top = np.argsort(-rdeg[head_rows], kind="stable")[:max_head_rows]
        head_rows = np.sort(head_rows[top])
    if head_rows.size < min_head_rows:
        head_rows = np.zeros(0, dtype=np.int64)
    if head_rows.size:
        in_hrow = np.zeros(m, dtype=bool)
        in_hrow[head_rows] = True
        on_hrow = rem & in_hrow[rows]
        taken |= on_hrow
        row_rank = np.zeros(m, dtype=np.int64)
        row_rank[head_rows] = np.arange(head_rows.size)
        head_rows_dense = np.zeros((head_rows.size, k), dtype=np.float32)
        rsel_ = np.flatnonzero(on_hrow)
        np.add.at(head_rows_dense, (row_rank[rows[rsel_]], cols[rsel_]), vals[rsel_])
    else:
        head_rows_dense = np.zeros((0, k), dtype=np.float32)

    # --- residue ---
    rsel = np.flatnonzero(~taken)
    residue = COOMatrix(
        (m, k),
        coo.rows[rsel],
        coo.cols[rsel],
        coo.vals[rsel],
    )
    return HybridSplit(
        m=m,
        k=k,
        nnz=coo.nnz,
        diag_offsets=diag_offsets.astype(np.int64),
        diag_vals=diag_vals,
        head_cols=head_cols.astype(np.int32),
        head_dense=head_dense,
        head_rows=head_rows.astype(np.int32),
        head_rows_dense=head_rows_dense,
        residue=residue,
    )


class HybridSpmmPlan:
    """Compiled executor for a HybridSplit: one jitted program computing

        C' = residue_kernel(B, C_in = beta*C + alpha*(diag + head parts))

    with the residue kernel invoked at beta=1. Exposes the same
    ``__call__``/``repeat`` surface as SpmmPlan.
    """

    def __init__(
        self,
        split: HybridSplit,
        n: int,
        *,
        residue_config: Optional[SpmmConfig] = None,
        residue_fmt: Optional[str] = None,
        backend: str = "auto",
        pack_cache=None,
        cache_name: Optional[str] = None,
        precise: int = 0,
    ):
        """``pack_cache``/``cache_name``: optional ``PackCache`` routing for
        the residue pack (cache_name must be unique per split — e.g.
        ``f"{matrix}@n{n}-residue"`` — the cache's content fingerprint
        protects non-trust_name callers either way).

        ``precise``: 0 = fast path. 1/2 = the precise composition
        (docs/ACCURACY.md): the residue engine runs precise (float64
        accumulation) with alpha=1/beta=0, and the parts combine through
        error-free transforms (ops/df32.py) with one final rounding per
        element — instead of the fast path's chained
        ``C_in = beta*C + alpha*(dense parts)`` feed into the residue,
        which rounds at full magnitude once per stage."""
        import jax
        import jax.numpy as jnp

        from sextans_tpu.format.pack import pack
        from sextans_tpu.format.pack_mxu import pack_mxu
        from sextans_tpu.ops.plan import SpmmPlan

        self.split = split
        self.m, self.k = split.m, split.k
        self.n = n
        self.precise = int(precise)

        if residue_config is None or residue_fmt is None:
            from sextans_tpu.utils.autotune import choose_backend

            if split.residue.nnz > 0:
                best = choose_backend(split.residue, n=n)[0]
                residue_config = residue_config or best.config
                residue_fmt = residue_fmt or best.fmt
            else:
                residue_config = residue_config or SpmmConfig()
                residue_fmt = residue_fmt or "vpu"
        self.residue_fmt = residue_fmt
        self.residue_config = residue_config

        if pack_cache is not None and cache_name is not None:
            packed = pack_cache.get_or_pack(
                cache_name, split.residue, residue_config, residue_fmt
            )
        elif residue_fmt == "mxu":
            packed = pack_mxu(split.residue, residue_config)
        elif residue_fmt == "edge":
            from sextans_tpu.format.pack_edge import pack_edge

            packed = pack_edge(split.residue, residue_config)
        elif residue_fmt == "ell":
            from sextans_tpu.format.pack_ell import pack_ell

            packed = pack_ell(split.residue, residue_config)
        else:
            packed = pack(split.residue, residue_config)
        if self.precise and not packed.config.precise:
            # precise is kernel-only: swap the config on the (possibly
            # cached) pack and share its device-upload memo — the packed
            # arrays are identical (same trick as the suite's precise
            # attempt, benchmarks/suite.py)
            import dataclasses

            repacked = dataclasses.replace(
                packed, config=packed.config.with_(precise=self.precise)
            )
            repacked.__dict__["_dev_cache"] = packed.__dict__.setdefault(
                "_dev_cache", {}
            )
            packed = repacked
        self._residue_plan = SpmmPlan(packed, n, backend=backend)

        # device-resident dense components
        self._dev = {}
        self.has_diag = split.diag_offsets.size > 0
        self.has_head = split.head_cols.size > 0
        self.has_hrows = split.head_rows.size > 0
        if self.has_diag:
            self._dev["dvals"] = jnp.asarray(split.diag_vals)
        if self.has_head:
            self._dev["head"] = jnp.asarray(split.head_dense)
            self._dev["head_cols"] = jnp.asarray(split.head_cols)
        if self.has_hrows:
            self._dev["hrows"] = jnp.asarray(split.head_rows_dense)
            self._dev["hrows_idx"] = jnp.asarray(split.head_rows)

        offsets = [int(c) for c in split.diag_offsets]
        m, k = self.m, self.k
        has_diag, has_head = self.has_diag, self.has_head
        has_hrows = self.has_hrows
        has_residue = split.residue.nnz > 0
        res_jit = self._residue_plan._jit  # jitted fn: inlines when traced
        res_dev = self._residue_plan._dev
        dense_dev = tuple(
            self._dev[key]
            for key in ("dvals", "head", "head_cols", "hrows", "hrows_idx")
            if key in self._dev
        )
        pad_lo = max(0, -(min(offsets) if offsets else 0))
        pad_hi = max(0, (max(offsets) if offsets else 0) + m - k)

        def dia_part(dvals, b, alpha):
            """alpha * sum_d diag_d[:, None] * B[i + offset_d]: shifted
            slices of one padded B, which XLA fuses into one loop."""
            bp = jnp.pad(b, ((pad_lo, pad_hi), (0, 0)))
            acc = dvals[0][:, None] * jax.lax.slice_in_dim(
                bp, offsets[0] + pad_lo, offsets[0] + pad_lo + m
            )
            for j, off in enumerate(offsets[1:], start=1):
                acc = acc + dvals[j][:, None] * jax.lax.slice_in_dim(
                    bp, off + pad_lo, off + pad_lo + m
                )
            return alpha * acc

        def dense_parts(dense_args, b, c, alpha, beta):
            """beta*C + alpha*(diagonal + head contributions)."""
            args = list(dense_args)
            acc = beta * c
            if has_diag:
                acc = acc + dia_part(args.pop(0), b, alpha)
            if has_head:
                head = args.pop(0)
                head_cols = args.pop(0)
                bh = b[head_cols, :]  # (H, N) gather
                acc = acc + alpha * jnp.dot(
                    head,
                    bh,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )
            if has_hrows:
                hrows, hrows_idx = args
                hout = jnp.dot(
                    hrows,
                    b,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )  # (R, N)
                acc = acc.at[hrows_idx].add(alpha * hout)
            return acc

        def one_step(dense_args, res_args, b, c, alpha, beta):
            partial = dense_parts(dense_args, b, c, alpha, beta)
            if not has_residue:
                return partial
            return res_jit(res_args, b, partial, alpha, jnp.float32(1.0))

        if self.precise:
            # Precise composition (docs/ACCURACY.md): residue at
            # alpha=1/beta=0 through the precise engine, and all parts
            # combined with error-free transforms — ONE final rounding per
            # element instead of one per stage. The remaining floor is each
            # part's own f32 rounding (>= 0.5 ulp of its own magnitude).
            from sextans_tpu.ops.df32 import two_prod, two_sum

            res_noc = self._residue_plan._jit_noc
            prec_hi = jax.lax.Precision.HIGHEST

            def one_step(dense_args, res_args, b, c, alpha, beta):  # noqa: F811
                args = list(dense_args)
                acc, resid = two_prod(beta, c)
                if has_diag:
                    p, pe = two_prod(alpha, dia_part(args.pop(0), b, jnp.float32(1.0)))
                    acc, e = two_sum(acc, p)
                    resid = resid + (pe + e)
                if has_head:
                    head = args.pop(0)
                    head_cols = args.pop(0)
                    h = jnp.dot(
                        head, b[head_cols, :],
                        preferred_element_type=jnp.float32,
                        precision=prec_hi,
                    )
                    p, pe = two_prod(alpha, h)
                    acc, e = two_sum(acc, p)
                    resid = resid + (pe + e)
                if has_hrows:
                    hrows, hrows_idx = args
                    hout = jnp.dot(
                        hrows, b,
                        preferred_element_type=jnp.float32,
                        precision=prec_hi,
                    )  # (R, N)
                    p, pe = two_prod(alpha, hout)
                    s, e = two_sum(acc[hrows_idx], p)
                    acc = acc.at[hrows_idx].set(s)  # head_rows are unique
                    resid = resid.at[hrows_idx].add(pe + e)
                if has_residue:
                    r_ = res_noc(res_args, b, jnp.float32(1.0))
                    p, pe = two_prod(alpha, r_)
                    acc, e = two_sum(acc, p)
                    resid = resid + (pe + e)
                return acc + resid

        def step(dense_args, res_args, b, c, alpha, beta):
            return one_step(dense_args, res_args, b, c, alpha, beta)

        self._step = jax.jit(step)

        # in-device rp_time chain: the ENTIRE hybrid step (dense parts +
        # residue kernel) repeats inside one dispatch, C fed back as carry.
        def _make_repeat(times):
            def rep(dense_args, res_args, b, c, alpha, beta):
                def body(_, c_acc):
                    return one_step(dense_args, res_args, b, c_acc, alpha, beta)

                return jax.lax.fori_loop(0, times, body, c)

            return jax.jit(rep)

        self._make_repeat = _make_repeat
        self._repeat_cache = {}
        self._dense_args = dense_dev
        self._res_args = res_dev

    def _coerce(self, b, beta, c):
        import jax.numpy as jnp

        b = jnp.asarray(b, dtype=jnp.float32)
        if b.shape != (self.k, self.n):
            raise ValueError(f"B must be ({self.k}, {self.n}), got {b.shape}")
        if c is None:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            c = jnp.zeros((self.m, self.n), dtype=jnp.float32)
        else:
            c = jnp.asarray(c, dtype=jnp.float32)
            if c.shape != (self.m, self.n):
                raise ValueError(f"C must be ({self.m}, {self.n}), got {c.shape}")
        return b, c

    def __call__(self, b, alpha=1.0, beta=0.0, c=None):
        import jax.numpy as jnp

        from sextans_tpu.ops.engines import precision_scope, scalar_f32

        b, c = self._coerce(b, beta, c)
        with precision_scope(self._residue_plan.precise):
            return self._step(
                self._dense_args, self._res_args, b, c,
                scalar_f32(alpha), scalar_f32(beta),
            )

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1):
        """In-device rp_time chain over the full hybrid step (one dispatch)."""
        import jax.numpy as jnp

        from sextans_tpu.ops.engines import precision_scope, scalar_f32

        b, c = self._coerce(b, beta, c)
        if times not in self._repeat_cache:
            self._repeat_cache[times] = self._make_repeat(times)
        with precision_scope(self._residue_plan.precise):
            return self._repeat_cache[times](
                self._dense_args, self._res_args, b, c,
                scalar_f32(alpha), scalar_f32(beta),
            )
