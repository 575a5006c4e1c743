"""SpmmPlan: a reusable, device-resident execution plan for one packed matrix.

The reference host uploads A/B/C channel buffers once and then invokes the
kernel rp_time times in-device (src/sextans-host.cpp:236-252). Here
``SpmmPlan`` uploads the packed arrays once and jit-compiles a single
program that pads B/C, runs the engine (ops/engines.py) and slices the
result, so a steady-state call moves only B and C, with zero host-side
repacking.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from sextans_tpu.ops.engines import (
    device_arrays,
    format_of,
    precision_scope,
    resolve_backend,
    run_padded,
    scalar_f32,
)

__all__ = ["SpmmPlan"]


class SpmmPlan:
    """Compiled SpMM executor for a fixed (packed A, N, backend).

    Accepts every packed format; ``backend="auto"`` takes the platform's
    engine for the format (ops/engines.py). A precise pack
    (``config.precise``) accumulates in float64: its calls run with x64
    enabled.
    """

    def __init__(self, packed, n: int, backend: str = "auto"):
        cfg = packed.config
        self.fmt = format_of(packed)
        self.backend = resolve_backend(self.fmt, backend,
                                       precise=cfg.precise)
        self.packed = packed
        self.m, self.k = packed.shape
        self.n = n
        self._dev = device_arrays(packed)
        self.precise = int(cfg.precise)

        backend = self.backend
        m, k = self.m, self.k
        m_padded, k_padded = packed.m_padded, packed.k_padded
        m_base = getattr(packed, "m_base", 0)
        # the ELL engines take C and return the result at M rows
        m_c = m if self.fmt == "ell" else m_padded

        def run(dev, b_p, c_p, alpha, beta, with_c=True):
            return run_padded(backend, cfg, dev, b_p, c_p, alpha, beta,
                              m_base=m_base, with_c=with_c)

        col_perm = (
            jnp.asarray(packed.col_perm) if packed.col_perm is not None else None
        )
        row_perm = getattr(packed, "row_perm", None)
        if row_perm is not None:
            inv = np.empty(m, dtype=np.int32)
            inv[row_perm] = np.arange(m, dtype=np.int32)
            inv_row = jnp.asarray(inv)
            row_perm = jnp.asarray(row_perm)
        else:
            inv_row = None

        def _pad_b(b):
            # degree-sorted pack: feed the engine B rows in packed column order
            b = b if col_perm is None else b[col_perm]
            return jnp.pad(b, ((0, k_padded - k), (0, 0)))

        def _pad_c(c):
            # 2-D reorder: the engine works in row-permuted space; C rows
            # are gathered in here and scattered back in _unpad_out
            c = c if row_perm is None else c[row_perm]
            return jnp.pad(c, ((0, m_c - m), (0, 0)))

        def _unpad_out(out):
            out = out[:m]
            return out if inv_row is None else out[inv_row]

        def _step(dev, b, c, alpha, beta):
            return _unpad_out(run(dev, _pad_b(b), _pad_c(c), alpha, beta))

        def _step_noc(dev, b, alpha):
            # beta == 0 without C: the engine never reads a C operand
            c_shape = jnp.zeros((m_c, n), jnp.float32)
            out = run(dev, _pad_b(b), c_shape, alpha, jnp.float32(0.0),
                      with_c=False)
            return _unpad_out(out)

        self._jit = jax.jit(_step)
        self._jit_noc = jax.jit(_step_noc)

        def _repeat(times):
            def rep(dev, b, c, alpha, beta):
                b_p = _pad_b(b)
                # the chain runs in row-permuted space; the gather/scatter
                # sit outside the loop
                c_p = _pad_c(c)

                def body(_, c_acc):
                    # tie B to the carry so loop-invariant code motion
                    # cannot hoist A @ B out of the loop; the ~1e-38 * |C|
                    # perturbation is absorbed by float32 rounding
                    b_i = b_p + c_acc[0:1, 0:1] * jnp.float32(1e-38)
                    return run(dev, b_i, c_acc, alpha, beta)

                return _unpad_out(jax.lax.fori_loop(0, times, body, c_p))

            return jax.jit(rep)

        self._repeat_cache = {}
        self._make_repeat = _repeat

    def _coerce(self, b, beta, c):
        b = jnp.asarray(b, dtype=jnp.float32)
        if b.shape != (self.k, self.n):
            raise ValueError(f"B must be ({self.k}, {self.n}), got {b.shape}")
        if c is None:
            if float(beta) != 0.0:
                raise ValueError("beta != 0 requires an input C")
            return b, None
        c = jnp.asarray(c, dtype=jnp.float32)
        if c.shape != (self.m, self.n):
            raise ValueError(f"C must be ({self.m}, {self.n}), got {c.shape}")
        return b, c

    def repeat(self, b, alpha=1.0, beta=0.0, c=None, times: int = 1) -> jax.Array:
        """Run the kernel ``times`` times in-device, feeding C back each
        iteration — ONE dispatch. The exact analog of the reference's
        rp_time loop (P_N bits 31:16, src/sextans-host.cpp:223;
        src/sextans.cpp:54-60): timing this and dividing by ``times``
        excludes all host dispatch overhead."""
        if times not in self._repeat_cache:
            self._repeat_cache[times] = self._make_repeat(times)
        b, c = self._coerce(b, beta, c)
        if c is None:
            c = jnp.zeros((self.m, self.n), dtype=jnp.float32)
        with precision_scope(self.precise):
            return self._repeat_cache[times](
                self._dev, b, c, scalar_f32(alpha), scalar_f32(beta)
            )

    def __call__(self, b, alpha=1.0, beta=0.0, c=None) -> jax.Array:
        b, c = self._coerce(b, beta, c)
        with precision_scope(self.precise):
            if c is None:
                return self._jit_noc(self._dev, b, scalar_f32(alpha))
            return self._jit(
                self._dev, b, c, scalar_f32(alpha), scalar_f32(beta)
            )
