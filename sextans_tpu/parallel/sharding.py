"""Multi-chip SpMM via shard_map over a device mesh.

The multi-device replacement for the reference's single-FPGA HBM-channel
parallelism (SURVEY.md §2.4): A and C are 1-D row-block sharded over the
mesh's ``"x"`` axis (each device owns a contiguous row slab), B is
replicated, and every device runs the single-device engine on its slab.
Row-sharded SpMM needs **no** cross-device collectives in the forward
product — C rows are produced where A rows live; XLA inserts the B
broadcast.

A K-sharded variant with ``psum``/reduce-scatter of C partials is provided
for matrices whose K dimension dominates (``spmm_sharded_k``).
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
    run_padded,
    scalar_f32,
)
from sextans_tpu.parallel.partition import ShardedSpMatrix

__all__ = [
    "spmm_sharded",
    "spmm_sharded_k",
    "ShardedSpmmPlan",
    "ShardedSpmmPlanK",
    "make_mesh",
]


def make_mesh(n_devices: Optional[int] = None, axis: str = "x") -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def make_local_kernel(cfg, backend: str, m_local: int):
    """Per-shard engine call shared by the row-sharded plans.

    Returns ``run(vals, qrow, bcol, gmt, gkw, b_pad, c_loc, alpha, beta)
    -> (m_local, n)`` operating on ONE shard's (unstacked) arrays, used
    inside shard_map by ShardedSpmmPlan and ShardedHybridPlan
    (parallel/hybrid_sharded.py)."""

    def run(vals, qrow, bcol, gmt, gkw, b_pad, c_loc, alpha, beta):
        # an ELL shard's virtual hub rows start after its m_local real rows
        return run_padded(backend, cfg, (vals, qrow, bcol, gmt, gkw), b_pad,
                          c_loc, alpha, beta, m_base=m_local)

    return run


class ShardedSpmmPlan:
    """Device-resident row-block-sharded executor (multi-chip SpmmPlan).

    Uploads the stacked shard arrays to the mesh once; each call moves only
    B (replicated) and C (row-sharded) — the multi-chip twin of
    ops/plan.SpmmPlan.
    """

    def __init__(
        self,
        sharded: ShardedSpMatrix,
        n: int,
        *,
        mesh: Optional[Mesh] = None,
        backend: str = "auto",
    ):
        if sharded.mode != "row":
            raise ValueError("ShardedSpmmPlan needs a pack_sharded (row) matrix")
        mesh = mesh or make_mesh(sharded.n_shards)
        if mesh.devices.size != sharded.n_shards:
            raise ValueError(
                f"matrix packed for {sharded.n_shards} shards but mesh has "
                f"{mesh.devices.size} devices"
            )
        fmt = getattr(sharded, "fmt", "vpu")
        cfg = sharded.config
        backend = resolve_backend(fmt, backend, precise=cfg.precise)
        self.backend = backend
        self.mesh = mesh
        self.sharded = sharded
        self.m, self.k = sharded.m, sharded.k
        self.n = n

        axis = mesh.axis_names[0]
        shard_spec = P(axis)
        repl = P()
        m, k = self.m, self.k
        m_padded = sharded.m_padded
        k_padded = self.k if fmt == "ell" else sharded.k_padded
        n_padded = n
        S, m_local = sharded.n_shards, sharded.m_local

        run_local = make_local_kernel(cfg, backend, m_local)

        def local_step(vals, qrow, bcol, gmt, gkw, b_pad, c_loc, alpha, beta):
            # shard_map hands each device its (1, ...) slice — drop the axis.
            out = run_local(
                vals[0], qrow[0], bcol[0], gmt[0], gkw[0], b_pad, c_loc[0],
                alpha, beta,
            )
            return out[None]

        inner = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(shard_spec,) * 5 + (repl, shard_spec, repl, repl),
            out_specs=shard_spec,
            # the kernels allocate unvarying accumulators internally; skip
            # the varying-manual-axes type check rather than threading pvary
            # through backends that also run un-sharded
            check_vma=False,
        )

        # nnz-balanced sharding: m-tiles are LPT-permuted across shards
        # (partition.py tile_assign); scatter C tiles to their owners on the
        # way in and gather them back on the way out — two cheap device-side
        # permutations bracketing the kernel (never inside the repeat chain).
        tm = cfg.tile_m
        if sharded.tile_assign is not None:
            assign_flat = jnp.asarray(
                sharded.tile_assign.reshape(-1).astype(np.int32)
            )
            inv_perm = jnp.asarray(
                np.argsort(sharded.tile_assign.reshape(-1)).astype(np.int32)
            )
            t_pad = S * (m_local // tm)

            def to_stacked(c_p):
                tiles = c_p.reshape(t_pad, tm, n_padded)
                return tiles[assign_flat].reshape(S, m_local, n_padded)

            def from_stacked(out):
                tiles = out.reshape(t_pad, tm, n_padded)
                return tiles[inv_perm].reshape(m_padded, n_padded)
        else:

            def to_stacked(c_p):
                return c_p.reshape(S, m_local, n_padded)

            def from_stacked(out):
                return out.reshape(m_padded, n_padded)

        def step(vals, qrow, bcol, gmt, gkw, b, c, alpha, beta):
            b_p = jnp.pad(b, ((0, k_padded - k), (0, 0)))
            c_p = jnp.pad(c, ((0, m_padded - m), (0, 0)))
            c_stacked = to_stacked(c_p)
            out = inner(vals, qrow, bcol, gmt, gkw, b_p, c_stacked, alpha, beta)
            return from_stacked(out)[:m]

        self._jit = jax.jit(step)

        # in-device rp_time repeat loop, multi-chip twin of SpmmPlan.repeat
        # (src/sextans.cpp:54-60): C chained through the carry so repeats
        # cannot overlap; used by the sharded timing harness.
        def _make_repeat(times):
            def rep(vals, qrow, bcol, gmt, gkw, b, c, alpha, beta):
                b_p = jnp.pad(b, ((0, k_padded - k), (0, 0)))
                c_p = jnp.pad(c, ((0, m_padded - m), (0, 0)))
                c_stacked = to_stacked(c_p)

                def body(_, c_acc):
                    # tie B to the carry so loop-invariant code motion
                    # cannot hoist A @ B out of the timing loop (same trick
                    # as ops/plan.py)
                    b_i = b_p + c_acc[0, 0:1, 0:1] * jnp.float32(1e-38)
                    return inner(
                        vals, qrow, bcol, gmt, gkw, b_i, c_acc, alpha, beta
                    )

                out = jax.lax.fori_loop(0, times, body, c_stacked)
                return from_stacked(out)[:m]

            return jax.jit(rep)

        self._repeat_cache = {}
        self._make_repeat = _make_repeat
        ns = NamedSharding(mesh, shard_spec)
        self._dev = (
            jax.device_put(jnp.asarray(sharded.vals), ns),
            jax.device_put(jnp.asarray(sharded.qrow), ns),
            jax.device_put(jnp.asarray(sharded.bcol), ns),
            jax.device_put(jnp.asarray(sharded.group_mtile), ns),
            jax.device_put(jnp.asarray(sharded.group_kwin), ns),
        )

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
                raise ValueError(f"C must be ({self.m}, {self.n}), got {c.shape}")
        return b, c

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> jax.Array:
        b, c = self._check_bc(b, beta, c)
        with precision_scope(self.sharded.config.precise):
            return self._jit(
                *self._dev, b, c, scalar_f32(alpha), scalar_f32(beta)
            )

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1) -> jax.Array:
        """Run the sharded kernel ``times`` times in-device (one dispatch),
        feeding C back each iteration — the multi-chip rp_time analog."""
        b, c = self._check_bc(b, beta, c)
        if times not in self._repeat_cache:
            self._repeat_cache[times] = self._make_repeat(times)
        with precision_scope(self.sharded.config.precise):
            return self._repeat_cache[times](
                *self._dev, b, c, scalar_f32(alpha), scalar_f32(beta)
            )


class ShardedSpmmPlanK:
    """Device-resident K-sharded executor with a reduce-scatter.

    The plan twin of :func:`spmm_sharded_k`: uploads the stacked column-slab
    shards to the mesh ONCE and jit-caches the step, so steady-state calls
    move only B and C (the one-shot function re-device_put every operand per
    call — unusable for steady-state multi-chip serving).

    Each chip computes a full-M partial product over its K slab, then
    ``psum_scatter`` sums partials across devices while scattering C row slabs to
    their owners; the alpha/beta epilogue runs on the owning chip.
    """

    def __init__(
        self,
        sharded: ShardedSpMatrix,
        n: int,
        *,
        mesh: Optional[Mesh] = None,
        backend: str = "auto",
    ):
        if sharded.mode != "col":
            raise ValueError("ShardedSpmmPlanK needs a pack_sharded_k matrix")
        mesh = mesh or make_mesh(sharded.n_shards)
        if mesh.devices.size != sharded.n_shards:
            raise ValueError(
                f"matrix packed for {sharded.n_shards} shards but mesh has "
                f"{mesh.devices.size} devices"
            )
        fmt = getattr(sharded, "fmt", "vpu")
        cfg = sharded.config
        backend = resolve_backend(fmt, backend, precise=cfg.precise)
        self.backend = backend
        self.mesh = mesh
        self.sharded = sharded
        self.m, self.k = sharded.m, sharded.k
        self.n = n

        axis = mesh.axis_names[0]
        m, k = self.m, self.k
        S = sharded.n_shards
        m_padded = sharded.m_padded  # divisible by S by construction
        k_local = sharded.k_padded
        n_padded = n

        def local_step(vals, qrow, bcol, gmt, gkw, b_loc, c_loc, alpha, beta):
            dev = (vals[0], qrow[0], bcol[0], gmt[0], gkw[0])
            b_loc, c_loc = b_loc[0], c_loc[0]
            one, zero = jnp.float32(1.0), jnp.float32(0.0)
            # each chip's full-M partial over its own K slab of B; ELL
            # virtual hub rows beyond the global padded M are folded in
            partial_ab = run_padded(
                backend, cfg, dev, b_loc, jnp.zeros((m_padded, n), jnp.float32),
                one, zero, m_base=m_padded, with_c=False,
            )
            slab = jax.lax.psum_scatter(
                partial_ab, axis, scatter_dimension=0, tiled=True
            )
            return (alpha * slab + beta * c_loc)[None]

        shard_spec = P(axis)
        inner = jax.shard_map(
            local_step,
            mesh=mesh,
            in_specs=(shard_spec,) * 7 + (P(), P()),
            out_specs=shard_spec,
            check_vma=False,
        )

        def stack_operands(b, c):
            b_p = jnp.pad(b, ((0, S * k_local - k), (0, 0)))
            c_p = jnp.pad(c, ((0, m_padded - m), (0, 0)))
            return (b_p.reshape(S, k_local, n_padded),
                    c_p.reshape(S, m_padded // S, n_padded))

        def step(vals, qrow, bcol, gmt, gkw, b, c, alpha, beta):
            b_stacked, c_stacked = stack_operands(b, c)
            out = inner(
                vals, qrow, bcol, gmt, gkw, b_stacked, c_stacked, alpha, beta
            )
            return out.reshape(m_padded, n_padded)[:m]

        self._jit = jax.jit(step)

        def _make_repeat(times):
            def rep(vals, qrow, bcol, gmt, gkw, b, c, alpha, beta):
                b_stacked, c_stacked = stack_operands(b, c)

                def body(_, c_acc):
                    return inner(
                        vals, qrow, bcol, gmt, gkw, b_stacked, c_acc,
                        alpha, beta,
                    )

                out = jax.lax.fori_loop(0, times, body, c_stacked)
                return out.reshape(m_padded, n_padded)[:m]

            return jax.jit(rep)

        self._repeat_cache = {}
        self._make_repeat = _make_repeat

        ns = NamedSharding(mesh, shard_spec)
        self._dev = (
            jax.device_put(jnp.asarray(sharded.vals), ns),
            jax.device_put(jnp.asarray(sharded.qrow), ns),
            jax.device_put(jnp.asarray(sharded.bcol), ns),
            jax.device_put(jnp.asarray(sharded.group_mtile), ns),
            jax.device_put(jnp.asarray(sharded.group_kwin), ns),
        )

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
                raise ValueError(f"C must be ({self.m}, {self.n}), got {c.shape}")
        return b, c

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> jax.Array:
        b, c = self._check_bc(b, beta, c)
        with precision_scope(self.sharded.config.precise):
            return self._jit(
                *self._dev, b, c, scalar_f32(alpha), scalar_f32(beta)
            )

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1) -> jax.Array:
        b, c = self._check_bc(b, beta, c)
        if times not in self._repeat_cache:
            self._repeat_cache[times] = self._make_repeat(times)
        with precision_scope(self.sharded.config.precise):
            return self._repeat_cache[times](
                *self._dev, b, c, scalar_f32(alpha), scalar_f32(beta)
            )


def spmm_sharded(
    sharded: ShardedSpMatrix,
    b,
    alpha: float = 1.0,
    beta: float = 0.0,
    c=None,
    *,
    mesh: Optional[Mesh] = None,
    backend: str = "auto",
) -> jax.Array:
    """Row-block sharded C = alpha*A@B + beta*C over the mesh.

    ``b`` is (K, N) replicated; ``c`` is (M, N) row-sharded like the result.
    Returns the global (M, N) array (sharded; materialize with np.asarray).
    One-shot convenience over :class:`ShardedSpmmPlan` (which is cached on
    the sharded matrix for reuse).
    """
    b = jnp.asarray(b, dtype=jnp.float32)
    if b.ndim != 2 or b.shape[0] != sharded.k:
        raise ValueError(f"B must be ({sharded.k}, N), got {b.shape}")
    n = b.shape[1]
    cache = getattr(sharded, "_plan_cache", None)
    if cache is None:
        cache = {}
        sharded._plan_cache = cache
    key = (n, backend, None if mesh is None else id(mesh))
    if key not in cache:
        cache[key] = ShardedSpmmPlan(sharded, n, mesh=mesh, backend=backend)
    return cache[key](b, alpha, beta, c)


def spmm_sharded_k(
    sharded: ShardedSpMatrix,
    b,
    alpha: float = 1.0,
    beta: float = 0.0,
    c=None,
    *,
    mesh: Optional[Mesh] = None,
    backend: str = "auto",
) -> jax.Array:
    """K-sharded C = alpha*A@B + beta*C with a reduce-scatter.

    A is column-slab sharded and B row-slab sharded along K; each chip
    computes a full-M partial product, then ``psum_scatter`` sums the
    partials across devices while scattering C rows — the device-parallel rebirth of
    the reference's 8-channel A / 4-channel B HBM streaming
    (link_config.ini:2-34). The alpha/beta epilogue is applied after the
    reduction on the C-owning chip.

    Cached convenience over :class:`ShardedSpmmPlanK`: the packed shards are
    uploaded to the mesh once per (N, backend, mesh) and reused across calls.
    """
    b = jnp.asarray(b, dtype=jnp.float32)
    if b.ndim != 2 or b.shape[0] != sharded.k:
        raise ValueError(f"B must be ({sharded.k}, N), got {b.shape}")
    n = b.shape[1]
    cache = getattr(sharded, "_plan_cache", None)
    if cache is None:
        cache = {}
        sharded._plan_cache = cache
    key = (n, backend, None if mesh is None else id(mesh))
    if key not in cache:
        cache[key] = ShardedSpmmPlanK(sharded, n, mesh=mesh, backend=backend)
    return cache[key](b, alpha, beta, c)
