"""Row-sharded hybrid (structure-split) SpMM over a device mesh.

Closes the last modal split between single- and multi-chip execution:
round 4's CLI printed "--shards is incompatible with --hybrid", so the
stencil/power-law classes whose best single-chip engine is the hybrid
split (ops/hybrid.py) could not run it on a mesh. The reference has no
such split — every matrix runs the same datapath (src/sextans.cpp:886-983)
— and neither should we.

Every component of a :class:`~sextans_tpu.ops.hybrid.HybridSplit` is
row-partitionable by construction, so the whole composition shards along
the mesh's row axis with ZERO collectives in the step (B replicated, the
same property as the blocked row shard, parallel/sharding.py):

* **diagonals** — shard s owns ``diag_vals[:, lo:hi]``; its contribution
  reads the B window ``[lo + min_off, hi + max_off)``, gathered for every
  shard before the shard_map and passed in row-sharded (offsets stay
  static per compilation, so the per-shard program is SPMD-uniform);
* **dense head columns** — ``head_dense[lo:hi]`` shards; the (H, N)
  ``B[head_cols]`` gather is replicated work;
* **dense head rows** — each hub row lands on exactly one shard; per-shard
  hub lists are padded to the max count with zero rows (their
  scatter-adds contribute exact zeros);
* **residue** — the existing row-sharded blocked pack
  (parallel/partition.pack_sharded) with the SAME contiguous row slabs.

The per-shard step is the single-chip composition
``C' = residue_kernel(B, beta*C + alpha*(dense parts))`` — one jitted
program, repeatable in-device (the rp_time analog) like every other plan.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from sextans_tpu.ops.engines import (
    precision_scope,
    resolve_backend,
    scalar_f32,
)
from sextans_tpu.ops.hybrid import HybridSplit
from sextans_tpu.parallel.partition import pack_sharded
from sextans_tpu.parallel.sharding import make_local_kernel, make_mesh
from sextans_tpu.utils.config import SpmmConfig

__all__ = ["ShardedHybridPlan"]


class ShardedHybridPlan:
    """Row-sharded executor for a HybridSplit (multi-chip HybridSpmmPlan).

    Dense components and the residue pack are uploaded to the mesh once;
    each call moves only B (replicated) and C (row-sharded).
    """

    def __init__(
        self,
        split: HybridSplit,
        n: int,
        n_shards: Optional[int] = None,
        *,
        mesh: Optional[Mesh] = None,
        residue_config: Optional[SpmmConfig] = None,
        residue_fmt: Optional[str] = None,
        backend: str = "auto",
    ):
        mesh = mesh or make_mesh(n_shards)
        n_shards = mesh.devices.size
        self.mesh = mesh
        self.split = split
        self.m, self.k = split.m, split.k
        self.n = n

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

        # residue pack: contiguous row slabs so its partition lines up
        # with the dense components' slabs below (m_local is the shared
        # row-slab size)
        sharded_res = pack_sharded(
            split.residue, n_shards, residue_config, fmt=residue_fmt,
            balance="contiguous",
        )
        self.sharded_residue = sharded_res
        cfg = residue_config
        m_local = sharded_res.m_local
        S = n_shards
        m, k = self.m, self.k

        self.backend = resolve_backend(residue_fmt, backend,
                                       precise=cfg.precise)
        k_padded = self.k if residue_fmt == "ell" else sharded_res.k_padded

        # ---- dense components, stacked (S, ...) along the row slabs ----
        m_slab = S * m_local
        has_diag = split.diag_offsets.size > 0
        has_head = split.head_cols.size > 0
        has_hrows = split.head_rows.size > 0
        self.has_diag, self.has_head = has_diag, has_head
        self.has_hrows = has_hrows
        offsets = [int(o) for o in split.diag_offsets]
        dense_np = {}
        if has_diag:
            dv = np.zeros((split.diag_offsets.size, m_slab), np.float32)
            dv[:, :m] = split.diag_vals
            # (S, D, m_local): shard s's diagonal values for its row slab
            dense_np["dvals"] = (
                dv.reshape(-1, S, m_local).transpose(1, 0, 2).copy()
            )
        if has_head:
            hd = np.zeros((m_slab, split.head_cols.size), np.float32)
            hd[:m] = split.head_dense
            dense_np["head"] = hd.reshape(S, m_local, -1)
            dense_np["head_cols"] = np.broadcast_to(
                split.head_cols.astype(np.int32), (S, split.head_cols.size)
            ).copy()
        if has_hrows:
            owner = split.head_rows // m_local
            r_u = max(1, int(np.bincount(owner, minlength=S).max()))
            hri = np.zeros((S, r_u), np.int32)  # local row ids; pads -> 0
            hrd = np.zeros((S, r_u, k), np.float32)  # pads -> zero rows
            fill = np.zeros(S, np.int64)
            for j, r in enumerate(split.head_rows):
                s = int(owner[j])
                hri[s, fill[s]] = int(r - s * m_local)
                hrd[s, fill[s]] = split.head_rows_dense[j]
                fill[s] += 1
            dense_np["hrows_idx"] = hri
            dense_np["hrows"] = hrd

        # diagonal window geometry (shared, static): shard s reads padded-B
        # rows [s*m_local, s*m_local + m_local + win_extra) where B is
        # pre-padded by pad_lo; the windows are gathered before the
        # shard_map and arrive row-sharded
        pad_lo = max(0, -(min(offsets) if offsets else 0))
        win_extra = (max(offsets) + pad_lo) if offsets else 0
        dia_rows_needed = m_slab + win_extra
        win_rows = (np.arange(S)[:, None] * m_local
                    + np.arange(m_local + win_extra)[None, :])

        has_residue = split.residue.nnz > 0
        run_local = make_local_kernel(cfg, self.backend, m_local)
        axis = mesh.axis_names[0]

        # Local diagonal evaluation (ops/hybrid.dia_part, per shard): static
        # per-offset shifted slices of the shard's B window, which XLA fuses
        # into one loop.
        def dia_local(dvals_l, w, alpha):
            acc = None
            for j, off in enumerate(offsets):
                lo = off + pad_lo
                term = dvals_l[j][:, None] * w[lo: lo + m_local]
                acc = term if acc is None else acc + term
            return alpha * acc

        def local_step(res5, dense_l, b_pad, b_win, c_loc, alpha, beta):
            vals, qrow, bcol, gmt, gkw = (a[0] for a in res5)
            c_l = c_loc[0]
            args = {k_: v[0] for k_, v in dense_l.items()}
            partial = beta * c_l
            if has_diag:
                partial = partial + dia_local(args["dvals"], b_win[0], alpha)
            if has_head:
                bh = b_pad[args["head_cols"], :]  # (H, n) gather
                partial = partial + alpha * jnp.dot(
                    args["head"], bh,
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )
            if has_hrows:
                hout = jnp.dot(
                    args["hrows"], b_pad[:k, :],
                    preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST,
                )  # (R_u, n); pad rows are zero -> add exact zeros
                partial = partial.at[args["hrows_idx"]].add(alpha * hout)
            if not has_residue:
                return partial[None]
            out = run_local(
                vals, qrow, bcol, gmt, gkw, b_pad, partial,
                alpha, jnp.float32(1.0),
            )
            return out[None]

        shard_spec = P(axis)
        repl = P()
        inner = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(
                (shard_spec,) * 5,
                {k_: shard_spec for k_ in dense_np},
                repl, shard_spec, shard_spec, repl, repl,
            ),
            out_specs=shard_spec,
            check_vma=False,
        )

        def pad_operands(b, c):
            b_pad = jnp.pad(b, ((0, k_padded - k), (0, 0)))
            if has_diag:
                b_dia = jnp.pad(
                    b, ((pad_lo, max(0, dia_rows_needed - k - pad_lo)), (0, 0))
                )
                b_win = b_dia[win_rows]  # (S, m_local + win_extra, n)
            else:
                b_win = jnp.zeros((S, 1, n), jnp.float32)
            c_p = jnp.pad(c, ((0, m_slab - m), (0, 0)))
            return b_pad, b_win, c_p.reshape(S, m_local, n)

        def step(res5, dense_d, b, c, alpha, beta):
            b_pad, b_win, c_stacked = pad_operands(b, c)
            out = inner(res5, dense_d, b_pad, b_win, c_stacked, alpha, beta)
            return out.reshape(m_slab, n)[:m]

        self._jit = jax.jit(step)

        def _make_repeat(times):
            def rep(res5, dense_d, b, c, alpha, beta):
                b_pad, b_win, c_stacked = pad_operands(b, c)

                def body(_, c_acc):
                    return inner(
                        res5, dense_d, b_pad, b_win, c_acc, alpha, beta
                    )

                out = jax.lax.fori_loop(0, times, body, c_stacked)
                return out.reshape(m_slab, n)[:m]

            return jax.jit(rep)

        self._repeat_cache = {}
        self._make_repeat = _make_repeat

        ns = NamedSharding(mesh, shard_spec)
        self._res5 = tuple(
            jax.device_put(jnp.asarray(a), ns)
            for a in (
                sharded_res.vals, sharded_res.qrow, sharded_res.bcol,
                sharded_res.group_mtile, sharded_res.group_kwin,
            )
        )
        self._dense = {
            k_: jax.device_put(jnp.asarray(v), ns)
            for k_, v in dense_np.items()
        }

    def _check_bc(self, b, beta, c):
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
                raise ValueError(
                    f"C must be ({self.m}, {self.n}), got {c.shape}"
                )
        return b, c

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> jax.Array:
        b, c = self._check_bc(b, beta, c)
        with precision_scope(self.residue_config.precise):
            return self._jit(
                self._res5, self._dense, b, c,
                scalar_f32(alpha), scalar_f32(beta),
            )

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1):
        """In-device rp_time chain over the full sharded hybrid step."""
        b, c = self._check_bc(b, beta, c)
        if times not in self._repeat_cache:
            self._repeat_cache[times] = self._make_repeat(times)
        with precision_scope(self.residue_config.precise):
            return self._repeat_cache[times](
                self._res5, self._dense, b, c,
                scalar_f32(alpha), scalar_f32(beta),
            )
