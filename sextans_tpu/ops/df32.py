"""Double-float32 (error-free transform) primitives for precise mode.

The BASELINE.md north star asks for max-abs error <= 1e-6 vs the f64
oracle. For outputs with max|C| in [16, 32) one f32 ulp is 1.91e-6, so the
gate demands a *nearly correctly rounded* result: even a perfect Kahan
accumulation loses it again in the epilogue, where ``alpha*total +
beta*C_in`` performs two product roundings and one sum rounding (~1.5 ulp
worst case — exactly the 1.1-1.7e-6 band the round-4 canonical rows
stranded in as ``precise-missed``).

These helpers close that last gap with classic error-free transforms (no
FMA required):

* ``two_sum``  — Knuth's 6-op exact addition: ``a + b = s + e`` exactly.
* ``two_prod`` — Dekker's split product: ``a * b = p + e`` exactly
  (split constant 2^12 + 1 for the 24-bit f32 significand).
* ``compensated_epilogue`` — the fused ``alpha*(total - comp) + beta*cin``
  with every product and sum compensated and ONE final rounding.

All are plain jnp elementwise expressions. The engines' precise mode
accumulates in float64 instead (ops/spmm_xla.acc_dtype); these transforms
combine the parts of the hybrid plan's precise composition
(ops/hybrid.py). XLA does not reassociate float arithmetic by default.

The reference has no analog — its FP32 add pipeline accumulates in
schedule order (src/sextans.cpp:462-570) and its host gate is the looser
1e-4-relative / 2%-mismatch rule (src/sextans-host.cpp:272-282).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["two_sum", "two_prod", "acc_step", "compensated_epilogue"]

# Dekker split constant for float32: 2^ceil(24/2) + 1.
_SPLIT = 4097.0


def two_sum(a, b):
    """Exact addition: returns (s, e) with s = fl(a + b) and s + e = a + b."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split(a):
    c = jnp.float32(_SPLIT) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact product: returns (p, e) with p = fl(a * b) and p + e = a * b.

    Dekker's algorithm (no FMA): both factors split into 12-bit halves
    whose partial products are exact in f32. Overflows only for
    |a| or |b| > ~2^115 of the f32 range (the split multiply) — far
    outside any SpMM operand regime.

    PLATFORM SEMANTICS: the transforms assume no mul+add contraction.
    The XLA CPU backend contracts a caller's ``x + p`` into
    ``fma(a, b, x)`` (LLVM ffp-contract; no debug flag disables it, and
    ``optimization_barrier`` does not survive into the emitted LLVM),
    which perturbs ``two_sum``'s recovered residual by up to ~1 ulp of the
    running sum; whether the GPU backend contracts is not verified. Tests
    therefore assert the ~1-2 ulp faithful band, not exactness.
    Contraction INSIDE ``e``'s expression is harmless either way: every
    partial product there is exactly representable.
    """
    p = a * b
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def acc_step(acc, comp, x, xerr=None):
    """Neumaier-compensated accumulate.

    Returns ``(acc', comp')`` with ``acc' - comp' == (acc - comp) + x
    + xerr`` exact up to O(eps^2) of the residual arithmetic. Unlike
    classic Kahan (``y = x - comp; t = s + y; c = (t - s) - y``), whose
    error term is exact only when ``|s| >= |y|``, the two_sum form holds
    for ANY magnitude ordering — the failure mode that left the round-4
    precise rows ~1 ulp off (a small running sum absorbing a larger
    contribution loses the compensation bits).

    ``comp`` keeps the kernels' existing convention: the amount by which
    ``acc`` OVERSTATES the true sum. ``xerr`` is an exact residual to ADD
    (e.g. the two_prod error of the term being accumulated).

    Without contraction the update is exact; on the contracting XLA CPU
    backend a bare-product ``x`` may fuse into the two_sum add (see
    two_prod's platform note) at ~1 ulp cost — accepted there.
    """
    t, e = two_sum(acc, x)
    c = comp - e
    if xerr is not None:
        c = c - xerr
    return t, c


def compensated_epilogue(alpha, total, comp, beta=None, cin=None):
    """Nearly correctly rounded ``alpha * (total - comp) + beta * cin``.

    ``(total, comp)`` is a Kahan pair in the kernels' convention: ``comp``
    holds the amount by which ``total`` OVERSTATES the true sum (the
    classic ``c = (t - s) - y`` compensation). Pass ``beta=None`` for the
    no-C variant ``alpha * (total - comp)``.

    Every product goes through two_prod and every sum through two_sum;
    all error terms fold into one low-order correction added in a single
    final rounding. Residual error ~0.5 ulp + O(eps^2) — enough to meet
    the 1e-6 gate whenever it is structurally reachable (ulp(max|C|)
    <= 2e-6, docs/ACCURACY.md).
    """
    p, pe = two_prod(alpha, total)
    err = pe - alpha * comp
    if beta is None or cin is None:
        return p + err
    q, qe = two_prod(beta, cin)
    s, se = two_sum(p, q)
    return s + (err + qe + se)
