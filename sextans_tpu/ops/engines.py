"""Engine choice and dispatch: the one place that maps a packed format and
the platform to the engine that runs it.

Formats and their engines:

========  =====================================  ===============================
format    pack                                   engines
========  =====================================  ===============================
``vpu``   8 x block_k blocks (format/pack.py)    ``xla`` (ops/spmm_xla.py)
``mxu``   block_k x 128 slabs (pack_mxu.py)      ``mxu`` (ops/spmm_xla.py)
``edge``  one record per nonzero (pack_edge.py)  ``edge`` (ops/spmm_xla.py)
``ell``   R slots per row (pack_ell.py)          ``ell`` (ops/spmm_ell_xla.py),
                                                 ``ell_triton``
                                                 (ops/spmm_ell_triton.py)
========  =====================================  ===============================

``backend="auto"`` picks per platform: ``gpu`` runs the Pallas/Triton
kernel for the ELL format and plain XLA for the others; ``cpu`` (the test
platform) runs plain XLA for every format; any other platform is an error.
``ell_triton`` is compiled for the GPU only and accumulates in float32
only, so a precise pack takes ``ell`` under ``auto``, and naming
``ell_triton`` off the GPU or for a precise pack is an error. The
``SEXTANS_TPU_BACKEND`` environment variable names a backend in place of
``auto`` and is checked like any explicit name.

Every engine takes the packed matrix as the same five device arrays (see
:func:`device_arrays`), so plans, the server and the sharded plans call
:func:`run_padded` without knowing which engine runs.
"""

from __future__ import annotations

import contextlib
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "ENGINES",
    "AUTO_ENGINES",
    "BACKEND_ENV",
    "format_of",
    "GPU_ONLY",
    "FLOAT32_ONLY",
    "resolve_backend",
    "device_arrays",
    "scalar_f32",
    "precision_scope",
    "run_padded",
]

ENGINES = {
    "vpu": ("xla",),
    "mxu": ("mxu",),
    "edge": ("edge",),
    "ell": ("ell", "ell_triton"),
}

AUTO_ENGINES = {
    "gpu": {"vpu": "xla", "mxu": "mxu", "edge": "edge", "ell": "ell_triton"},
    "cpu": {"vpu": "xla", "mxu": "mxu", "edge": "edge", "ell": "ell"},
}

# engines compiled for the GPU only; engines without float64 accumulation
GPU_ONLY = {"ell_triton"}
FLOAT32_ONLY = {"ell_triton"}

BACKEND_ENV = "SEXTANS_TPU_BACKEND"


def format_of(packed) -> str:
    """Format name of a packed matrix (or of a sharded one's ``fmt``)."""
    from sextans_tpu.format.pack_edge import PackedSpMatrixEdge
    from sextans_tpu.format.pack_ell import PackedSpMatrixELL
    from sextans_tpu.format.pack_mxu import PackedSpMatrixMXU

    if isinstance(packed, PackedSpMatrixMXU):
        return "mxu"
    if isinstance(packed, PackedSpMatrixEdge):
        return "edge"
    if isinstance(packed, PackedSpMatrixELL):
        return "ell"
    return getattr(packed, "fmt", "vpu")


def resolve_backend(
    fmt: str, backend: str = "auto", *, platform: str | None = None,
    precise: bool = False,
) -> str:
    """The engine that runs format ``fmt``: ``backend`` if named (checked
    against the format, the platform and ``precise``), else the platform's
    choice."""
    if fmt not in ENGINES:
        raise ValueError(f"unknown packed format {fmt!r}")
    if backend == "auto":
        backend = os.environ.get(BACKEND_ENV) or "auto"
    platform = platform or jax.devices()[0].platform
    if backend == "auto":
        if platform not in AUTO_ENGINES:
            raise ValueError(
                f"no SpMM engine for platform {platform!r} "
                f"(supported: {sorted(AUTO_ENGINES)})"
            )
        backend = AUTO_ENGINES[platform][fmt]
        if precise and backend in FLOAT32_ONLY:
            backend = ENGINES[fmt][0]
    if backend not in ENGINES[fmt]:
        raise ValueError(
            f"backend {backend!r} does not match packed format {fmt!r} "
            f"(engines: {ENGINES[fmt]})"
        )
    if backend in GPU_ONLY and platform != "gpu":
        raise ValueError(f"backend {backend!r} needs a GPU, not {platform!r}")
    if precise and backend in FLOAT32_ONLY:
        raise ValueError(
            f"backend {backend!r} accumulates in float32 only; a precise "
            f"pack needs {ENGINES[fmt][0]!r}"
        )
    return backend


def device_arrays(packed) -> tuple:
    """Upload a packed matrix once per device; memoized on the pack.

    The five slots are ``(vals, qrow|qm|meta|cols, bcol|fold_rows,
    group_mtile, group_kwin)``; formats without a slot carry a 1-int
    placeholder there."""
    dev_cache = packed.__dict__.setdefault("_dev_cache", {})
    d0 = jax.devices()[0]
    key = ("dev", d0.id, d0.platform)
    if key not in dev_cache:
        fmt = format_of(packed)
        ph = jnp.zeros((1,), jnp.int32)
        if fmt == "ell":
            arrays = (packed.vals, packed.cols, packed.fold_rows, ph, ph)
        elif fmt == "edge":
            arrays = (packed.vals, packed.meta, ph, packed.chunk_mtile,
                      packed.chunk_kwin)
        else:
            q = packed.qm if fmt == "mxu" else packed.qrow
            arrays = (packed.vals, q, packed.bcol, packed.group_mtile,
                      packed.group_kwin)
        dev_cache[key] = tuple(jnp.asarray(a) for a in arrays)
    return dev_cache[key]


def scalar_f32(x):
    """``x`` as a float32 scalar operand for a jitted call. Host numbers
    map to device scalars kept per value, so a call with the usual alpha and
    beta runs no eager conversion and no host-to-device copy for them;
    arrays and tracers pass through ``jnp.asarray``."""
    if isinstance(x, (int, float, np.number)):
        return _device_scalar(float(x))
    return jnp.asarray(x, jnp.float32)


@functools.lru_cache(maxsize=256)
def _device_scalar(x: float) -> jax.Array:
    return jnp.float32(x)


def precision_scope(precise):
    """Context for calling an engine: precise engines accumulate in float64
    (ops/spmm_xla.acc_dtype), which needs x64 enabled while they trace."""
    return jax.enable_x64(True) if precise else contextlib.nullcontext()


def run_padded(backend, cfg, dev, b_p, c_p, alpha, beta, *, m_base=0,
               with_c=True):
    """``alpha * A @ B + beta * C`` on padded operands with engine
    ``backend``; ``dev`` is the five-array tuple of :func:`device_arrays`.
    ``m_base`` is the first virtual hub row of an ELL pack; the ELL engines
    take C at any row count from ``m_base`` to ``m_padded`` and return that
    many rows. Returns the padded result; with ``with_c=False`` C is not
    read."""
    a0, a1, a2, a3, a4 = dev
    precise = int(cfg.precise)
    if backend == "ell":
        from sextans_tpu.ops.spmm_ell_xla import spmm_ell_padded

        return spmm_ell_padded(a0, a1, a2, b_p, c_p, alpha, beta,
                               m_base=m_base, with_c=with_c, precise=precise)
    if backend == "ell_triton":
        from sextans_tpu.ops.spmm_ell_triton import spmm_ell_triton

        return spmm_ell_triton(a0, a1, a2, b_p, c_p, alpha, beta,
                               m_base=m_base, with_c=with_c)
    from sextans_tpu.ops import spmm_xla

    kw = dict(tile_m=cfg.tile_m, window_k=cfg.window_k, with_c=with_c,
              precise=precise)
    if backend == "edge":
        return spmm_xla.spmm_edge_padded(a0, a1, a3, a4, b_p, c_p, alpha,
                                         beta, **kw)
    kw.update(block_k=cfg.block_k, group_blocks=cfg.group_blocks)
    if backend == "mxu":
        return spmm_xla.spmm_slab_padded(*dev, b_p, c_p, alpha, beta, **kw)
    if backend == "xla":
        return spmm_xla.spmm_xla_padded(*dev, b_p, c_p, alpha, beta, **kw)
    raise ValueError(f"unknown backend {backend!r}")
