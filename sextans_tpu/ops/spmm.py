"""Top-level SpMM API: C = alpha * A @ B + beta * C.

The library analog of the reference's host-side kernel launch
(``tapa::invoke(Sextans, ...)``, src/sextans-host.cpp:236-251): pads dense
operands to tile boundaries, dispatches to a backend, and slices the result
back to (M, N).

Backends (ops/engines.py lists them per packed format):

* ``"xla"``        — block engine over the 8 x block_k format;
* ``"mxu"``        — slab engine over the block_k x 128 dense-slab format;
* ``"edge"``       — per-nonzero gather/scatter over the edge format;
* ``"ell"``        — plain-XLA gather over the ELL format;
* ``"ell_triton"`` — Pallas/Triton gather over the ELL format (GPU only);
* ``"auto"``       — picked from the packed format + platform.
"""

from __future__ import annotations

from typing import Optional, Union

import jax
import jax.numpy as jnp

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSRMatrix, CSCMatrix
from sextans_tpu.format.pack import PackedSpMatrix, pack
from sextans_tpu.format.pack_edge import PackedSpMatrixEdge
from sextans_tpu.format.pack_ell import PackedSpMatrixELL
from sextans_tpu.format.pack_mxu import PackedSpMatrixMXU
from sextans_tpu.utils.config import SpmmConfig

__all__ = ["spmm", "prepare", "plan"]

MatrixLike = Union[
    PackedSpMatrix, PackedSpMatrixMXU, PackedSpMatrixEdge, PackedSpMatrixELL,
    COOMatrix, CSRMatrix, CSCMatrix,
]


def prepare(a: MatrixLike, config: Optional[SpmmConfig] = None) -> PackedSpMatrix:
    """Coerce any supported sparse container into the packed block format.

    Besides the library's own containers, accepts ``scipy.sparse``
    matrices/arrays, unbatched 2-D ``jax.experimental.sparse.BCOO``, and
    dense 2-D NumPy/JAX arrays (exact zeros dropped) — the switch-over
    surface for users arriving from other sparse stacks.
    """
    if isinstance(
        a,
        (PackedSpMatrix, PackedSpMatrixMXU, PackedSpMatrixEdge,
         PackedSpMatrixELL),
    ):
        return a
    cfg = config or SpmmConfig()
    if isinstance(a, (CSRMatrix, CSCMatrix)):
        a = a.to_coo()
    if not isinstance(a, COOMatrix):
        if hasattr(a, "tocoo"):  # any scipy.sparse format
            a = COOMatrix.from_scipy(a)
        elif type(a).__name__ == "BCOO":
            a = COOMatrix.from_bcoo(a)
        elif hasattr(a, "ndim") and getattr(a, "ndim", 0) == 2:
            import numpy as np

            a = COOMatrix.from_dense(np.asarray(a))
        else:
            raise TypeError(f"unsupported sparse matrix type {type(a)!r}")
    return pack(a, cfg)


def spmm(
    a: MatrixLike,
    b,
    alpha: float = 1.0,
    beta: float = 0.0,
    c=None,
    *,
    backend: str = "auto",
    config: Optional[SpmmConfig] = None,
) -> jax.Array:
    """Sparse-matrix x dense-matrix product with the reference semantics.

    ``a``: sparse (M, K) in any supported container (packed preferred —
    packing is the expensive host step, do it once per matrix).
    ``b``: dense (K, N) float32. ``c``: dense (M, N) float32, required when
    ``beta != 0`` (matching src/sextans-host.cpp semantics where C is always
    supplied; here it is optional for the common beta=0 case).
    """
    packed = prepare(a, config)
    m, k = packed.shape

    b = jnp.asarray(b, dtype=jnp.float32)
    if b.ndim != 2 or b.shape[0] != k:
        raise ValueError(f"B must be ({k}, N) dense, got {b.shape}")
    n = b.shape[1]
    return plan(packed, n, backend=backend)(b, alpha, beta, c)


def plan(packed: PackedSpMatrix, n: int, backend: str = "auto"):
    """Get (and cache on the packed matrix) a device-resident SpmmPlan."""
    from sextans_tpu.ops.plan import SpmmPlan

    cache = getattr(packed, "_plan_cache", None)
    if cache is None:
        cache = {}
        packed._plan_cache = cache
    key = (n, backend)
    if key not in cache:
        cache[key] = SpmmPlan(packed, n, backend=backend)
    return cache[key]
