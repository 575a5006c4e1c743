"""ctypes bindings for the native (C++) pack runtime.

Loads ``build/libsextans_runtime.so`` (building it with ``make`` on first use
if a toolchain is present) and exposes :func:`pack_native`, which produces
arrays bit-identical to the NumPy reference pack (format/pack.py). Falls back
silently: callers check :func:`available` first.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SO = _HERE / "build" / "libsextans_runtime.so"

_lib = None
_load_failed = False


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _SO.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_HERE)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except Exception:
            _load_failed = True
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        _load_failed = True
        return None

    lib.sx_pack_plan.restype = ctypes.c_void_p
    lib.sx_pack_plan.argtypes = [
        ctypes.c_int64,  # nnz
        ctypes.c_void_p,  # rows
        ctypes.c_void_p,  # cols
        ctypes.c_int64,  # m
        ctypes.c_int64,  # k
        ctypes.c_int32,  # tile_m
        ctypes.c_int32,  # window_k
        ctypes.c_int32,  # block_k
        ctypes.c_int32,  # group_blocks
        ctypes.c_int32,  # interleave
    ]
    for fn in ("sx_plan_nblocks", "sx_plan_ngroups", "sx_plan_njobs", "sx_plan_nempty"):
        getattr(lib, fn).restype = ctypes.c_int64
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.sx_pack_fill.restype = None
    lib.sx_pack_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 8
    lib.sx_pack_free.restype = None
    lib.sx_pack_free.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "sx_pack_plan_edge"):
        lib.sx_pack_plan_edge.restype = ctypes.c_void_p
        lib.sx_pack_plan_edge.argtypes = [
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        for fn in ("sx_edge_nchunks", "sx_edge_njobs", "sx_edge_nempty"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.sx_pack_fill_edge.restype = None
        lib.sx_pack_fill_edge.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
        lib.sx_pack_free_edge.restype = None
        lib.sx_pack_free_edge.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "sx_pack_plan_mxu"):
        lib.sx_pack_plan_mxu.restype = ctypes.c_void_p
        lib.sx_pack_plan_mxu.argtypes = [
            ctypes.c_int64,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int32,
        ]
        lib.sx_pack_fill_mxu.restype = None
        lib.sx_pack_fill_mxu.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 8
    _lib = lib
    return _lib


def available() -> bool:
    return _try_load() is not None


def available_mxu() -> bool:
    lib = _try_load()
    return lib is not None and hasattr(lib, "sx_pack_plan_mxu")


def pack_mxu_native(rows, cols, vals, m, k, config):
    """Native dense-slab pack. Returns
    (vals_packed, qm, bcol, group_mtile, group_kwin, (nb, njobs, nempty)) —
    bit-identical to the NumPy pack_mxu arrays."""
    lib = _try_load()
    if lib is None or not hasattr(lib, "sx_pack_plan_mxu"):
        raise RuntimeError("native mxu pack unavailable")

    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    nnz = rows.shape[0]

    h = lib.sx_pack_plan_mxu(
        nnz,
        rows.ctypes.data,
        cols.ctypes.data,
        m,
        k,
        config.tile_m,
        config.window_k,
        config.block_k,
        config.group_blocks,
    )
    if not h:
        raise RuntimeError("sx_pack_plan_mxu rejected parameters")
    try:
        nb = lib.sx_plan_nblocks(h)
        ngroups = lib.sx_plan_ngroups(h)
        njobs = lib.sx_plan_njobs(h)
        nempty = lib.sx_plan_nempty(h)
        G, bk = config.group_blocks, config.block_k

        vp = np.zeros((ngroups, G * bk, 128), dtype=np.float32)
        qm = np.zeros((ngroups, G), dtype=np.int32)
        bcol = np.zeros((ngroups, G), dtype=np.int32)
        group_mtile = np.zeros(ngroups + 1, dtype=np.int32)
        group_kwin = np.zeros(ngroups, dtype=np.int32)

        lib.sx_pack_fill_mxu(
            h,
            rows.ctypes.data,
            cols.ctypes.data,
            vals.ctypes.data,
            vp.ctypes.data,
            qm.ctypes.data,
            bcol.ctypes.data,
            group_mtile.ctypes.data,
            group_kwin.ctypes.data,
        )
        return vp, qm, bcol, group_mtile, group_kwin, (nb, njobs, nempty)
    finally:
        lib.sx_pack_free(h)


def pack_native(rows, cols, vals, m, k, config):
    """Run the native pack. Returns the same array tuple the NumPy pack
    builds: (vals_packed, qrow, bcol, group_mtile, group_kwin, counts)."""
    lib = _try_load()
    if lib is None:
        raise RuntimeError("native runtime unavailable")

    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    nnz = rows.shape[0]

    h = lib.sx_pack_plan(
        nnz,
        rows.ctypes.data,
        cols.ctypes.data,
        m,
        k,
        config.tile_m,
        config.window_k,
        config.block_k,
        config.group_blocks,
        1 if config.interleave else 0,
    )
    if not h:
        raise RuntimeError("sx_pack_plan rejected parameters")
    try:
        nb = lib.sx_plan_nblocks(h)
        ngroups = lib.sx_plan_ngroups(h)
        njobs = lib.sx_plan_njobs(h)
        nempty = lib.sx_plan_nempty(h)
        G, bk = config.group_blocks, config.block_k

        vp = np.zeros((ngroups, 8, G * bk), dtype=np.float32)
        qrow = np.zeros((ngroups, G), dtype=np.int32)
        bcol = np.zeros((ngroups, G), dtype=np.int32)
        group_mtile = np.zeros(ngroups + 1, dtype=np.int32)
        group_kwin = np.zeros(ngroups, dtype=np.int32)

        lib.sx_pack_fill(
            h,
            rows.ctypes.data,
            cols.ctypes.data,
            vals.ctypes.data,
            vp.ctypes.data,
            qrow.ctypes.data,
            bcol.ctypes.data,
            group_mtile.ctypes.data,
            group_kwin.ctypes.data,
        )
        return vp, qrow, bcol, group_mtile, group_kwin, (nb, njobs, nempty)
    finally:
        lib.sx_pack_free(h)


def available_edge() -> bool:
    lib = _try_load()
    return lib is not None and hasattr(lib, "sx_pack_plan_edge")


def pack_edge_native(rows, cols, vals, m, k, config):
    """Native edge-stream pack. Returns
    (vals_packed, meta, chunk_mtile, chunk_kwin, (nchunks, njobs, nempty)) —
    bit-identical to the NumPy pack_edge arrays."""
    lib = _try_load()
    if lib is None or not hasattr(lib, "sx_pack_plan_edge"):
        raise RuntimeError("native edge pack unavailable")

    rows = np.ascontiguousarray(rows, dtype=np.int32)
    cols = np.ascontiguousarray(cols, dtype=np.int32)
    vals = np.ascontiguousarray(vals, dtype=np.float32)
    nnz = rows.shape[0]

    h = lib.sx_pack_plan_edge(
        nnz,
        rows.ctypes.data,
        cols.ctypes.data,
        m,
        k,
        config.tile_m,
        config.window_k,
        config.edge_chunk,
        1,  # row runs unpadded: the engine scatters each edge on its own
    )
    if not h:
        raise RuntimeError("sx_pack_plan_edge rejected parameters")
    try:
        n_total = lib.sx_edge_nchunks(h)
        njobs = lib.sx_edge_njobs(h)
        nempty = lib.sx_edge_nempty(h)
        E = config.edge_chunk

        vp = np.zeros((n_total, 1, E), dtype=np.float32)
        meta = np.zeros((n_total, 1, E), dtype=np.int32)
        chunk_mtile = np.zeros(n_total + 1, dtype=np.int32)
        chunk_kwin = np.zeros(n_total, dtype=np.int32)

        lib.sx_pack_fill_edge(
            h,
            rows.ctypes.data,
            cols.ctypes.data,
            vals.ctypes.data,
            vp.ctypes.data,
            meta.ctypes.data,
            chunk_mtile.ctypes.data,
            chunk_kwin.ctypes.data,
        )
        return vp, meta, chunk_mtile, chunk_kwin, (n_total, njobs, nempty)
    finally:
        lib.sx_pack_free_edge(h)
