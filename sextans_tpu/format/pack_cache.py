"""Disk-backed pack cache: reuse packed matrices across processes and runs.

The reference's expensive host step is its preprocessing pass, and its
persistence story is bitstream reuse via the TAPAB env var
(reference README.md:46-48). Here the expensive host step is packing — on
45M-nnz matrices a single pack costs minutes and the benchmark suite packs
every (matrix, config) candidate in every pass — so packs are memoized on
disk keyed by (matrix identity, format, pack-relevant config fields).

Only the config fields that change the packed bytes participate in the key:
the engine-only knob ``precise`` varies freely over one cached pack. On load, the *caller's* full config is re-attached to the packed
object so those knobs take effect.

The cache directory defaults to ``$TMPDIR/sextans_pack_cache`` and is
overridable via ``SEXTANS_PACK_CACHE_DIR``. Small packs are ordinary
``.npz`` files written by each format's ``save`` (load round-trip is
tested in tests/test_pack*.py). Packs above ``SEXTANS_PACK_RAW_BYTES``
(default 32 MiB) are stored as a raw directory of ``.npy`` arrays plus a
``meta.json`` and loaded back with ``np.load(mmap_mode="r")``: no deflate
on write (pack values are random floats — compression wastes minutes per
ldoor-class pack for single-digit ratios) and no inflate-copy on read
(the device upload streams pages straight off the mapping). Either way
the cache doubles as the checkpoint/resume story for preprocessing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from pathlib import Path
from typing import Optional

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.utils.config import SpmmConfig

__all__ = ["PackCache", "pack_signature"]


def pack_signature(
    cfg: SpmmConfig, fmt: str, reorder_cols: bool, reorder_rows: bool = False
) -> str:
    """Canonical string of the fields that determine the packed bytes."""
    if fmt == "edge":
        fields = (cfg.tile_m, cfg.window_k, cfg.edge_chunk)
    elif fmt == "mxu":
        fields = (cfg.tile_m, cfg.window_k, cfg.block_k, cfg.group_blocks)
    elif fmt == "vpu":
        fields = (
            cfg.tile_m, cfg.window_k, cfg.block_k, cfg.group_blocks,
            int(cfg.interleave),
        )
    elif fmt == "ell":
        # ell_r None → deterministic cost-based choice per matrix, so the
        # (matrix fingerprint, tile_m, ell_r) key is stable either way
        fields = (cfg.tile_m, cfg.ell_r)
    else:
        raise ValueError(f"unknown pack format {fmt!r}")
    sig = f"{fmt}|{fields}|reorder={bool(reorder_cols)}"
    if reorder_rows:  # appended only when set: keys of older caches survive
        sig += "|rrows=True"
    return sig


# Packs larger than this are stored raw (npy-per-array + meta.json) and
# memmapped on load instead of npz deflate/inflate.
RAW_BYTES_DEFAULT = 32 << 20


def _packed_cls(fmt: str):
    if fmt == "edge":
        from sextans_tpu.format.pack_edge import PackedSpMatrixEdge

        return PackedSpMatrixEdge
    if fmt == "mxu":
        from sextans_tpu.format.pack_mxu import PackedSpMatrixMXU

        return PackedSpMatrixMXU
    if fmt == "ell":
        from sextans_tpu.format.pack_ell import PackedSpMatrixELL

        return PackedSpMatrixELL
    from sextans_tpu.format.pack import PackedSpMatrix

    return PackedSpMatrix


def _packed_nbytes(packed) -> int:
    import numpy as np

    return sum(
        getattr(packed, f.name).nbytes
        for f in dataclasses.fields(packed)
        if isinstance(getattr(packed, f.name), np.ndarray)
    )


def _raw_save(packed, d: Path) -> None:
    """Write a packed dataclass as raw .npy arrays + meta.json (atomic:
    built in a sibling tmp dir, renamed into place)."""
    import json
    import shutil

    import numpy as np

    from sextans_tpu.format.pack import PackStats

    tmp = d.with_name(d.name + f".tmp{os.getpid()}")
    tmp.mkdir(parents=True, exist_ok=True)
    meta = {"fields": {}, "version": 1}
    try:
        for f in dataclasses.fields(packed):
            v = getattr(packed, f.name)
            if isinstance(v, np.ndarray):
                np.save(tmp / f"{f.name}.npy", v)
                meta["fields"][f.name] = {"kind": "array"}
            elif isinstance(v, SpmmConfig):
                meta["fields"][f.name] = {
                    "kind": "config", "value": dataclasses.asdict(v)
                }
            elif isinstance(v, PackStats):
                meta["fields"][f.name] = {
                    "kind": "stats", "value": dataclasses.asdict(v)
                }
            elif v is None:
                meta["fields"][f.name] = {"kind": "none"}
            else:
                meta["fields"][f.name] = {"kind": "scalar", "value": v}
        (tmp / "meta.json").write_text(json.dumps(meta))
        try:
            os.rename(tmp, d)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # concurrent writer won
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _raw_load(d: Path, fmt: str):
    """Rebuild a packed dataclass from a raw dir; arrays are memmapped."""
    import json

    import numpy as np

    from sextans_tpu.format.pack import PackStats

    meta = json.loads((d / "meta.json").read_text())
    kwargs = {}
    for name, spec in meta["fields"].items():
        kind = spec["kind"]
        if kind == "array":
            kwargs[name] = np.load(d / f"{name}.npy", mmap_mode="r")
        elif kind == "config":
            kwargs[name] = SpmmConfig(**spec["value"])
        elif kind == "stats":
            kwargs[name] = PackStats(**spec["value"])
        elif kind == "none":
            kwargs[name] = None
        else:
            kwargs[name] = spec["value"]
    return _packed_cls(fmt)(**kwargs)


def _load_fmt(path: Path, fmt: str):
    if fmt == "edge":
        from sextans_tpu.format.pack_edge import PackedSpMatrixEdge

        return PackedSpMatrixEdge.load(path)
    if fmt == "mxu":
        from sextans_tpu.format.pack_mxu import PackedSpMatrixMXU

        return PackedSpMatrixMXU.load(path)
    if fmt == "ell":
        from sextans_tpu.format.pack_ell import PackedSpMatrixELL

        return PackedSpMatrixELL.load(path)
    from sextans_tpu.format.pack import PackedSpMatrix

    return PackedSpMatrix.load(path)


def _pack_fmt(coo: COOMatrix, cfg: SpmmConfig, fmt: str, reorder_cols: bool,
              reorder_rows: bool = False):
    if fmt == "edge":
        from sextans_tpu.format.pack_edge import pack_edge

        return pack_edge(coo, cfg, reorder_cols=reorder_cols,
                         reorder_rows_=reorder_rows)
    if fmt == "mxu":
        from sextans_tpu.format.pack_mxu import pack_mxu

        return pack_mxu(coo, cfg, reorder_cols=reorder_cols,
                        reorder_rows_=reorder_rows)
    if fmt == "ell":
        from sextans_tpu.format.pack_ell import pack_ell

        if reorder_cols or reorder_rows:
            raise ValueError(
                "ELL gather format is permutation-invariant; "
                "reorder flags are not supported"
            )
        return pack_ell(coo, cfg)
    from sextans_tpu.format.pack import pack

    return pack(coo, cfg, reorder_cols=reorder_cols,
                reorder_rows_=reorder_rows)


class PackCache:
    """Two-level (memory + disk) pack cache.

    ``name`` identifies the matrix. Callers that can guarantee name
    uniqueness (the benchmark suite's generated matrices are deterministic
    per name) may pass ``trust_name=True`` to skip hashing the COO arrays;
    otherwise a content fingerprint (shape/nnz + sampled entries) joins the
    key so a renamed or edited matrix can never alias a stale pack.
    """

    def __init__(self, root: Optional[os.PathLike] = None,
                 trust_name: bool = False):
        self.root = Path(
            root
            or os.environ.get("SEXTANS_PACK_CACHE_DIR")
            or Path(tempfile.gettempdir()) / "sextans_pack_cache"
        )
        self.trust_name = trust_name
        self._mem: dict = {}
        self._mem_fp: Optional[str] = None  # memory layer holds ONE matrix
        self.hits = 0
        self.disk_hits = 0
        self.misses = 0

    @staticmethod
    def _with_cfg(base, cfg: SpmmConfig):
        """Copy with the caller's config; shares the device-upload memo dict
        (ops/plan.py SpmmPlan) so all N-variants reuse one device copy."""
        if base.config == cfg:
            return base
        out = dataclasses.replace(base, config=cfg)
        out.__dict__["_dev_cache"] = base.__dict__.setdefault("_dev_cache", {})
        return out

    def _fingerprint(self, name: str, coo: COOMatrix) -> str:
        if self.trust_name:
            return name
        import numpy as np

        h = hashlib.sha1()
        h.update(f"{name}|{coo.shape}|{coo.nnz}".encode())
        # sampled entries: full-array hashing costs ~1 s per 100M elements,
        # a deterministic stride sample of 64k entries is plenty to detect
        # any real content change
        if coo.nnz:
            step = max(1, coo.nnz // 65536)
            for a in (coo.rows, coo.cols, coo.vals):
                h.update(np.ascontiguousarray(a[::step]).tobytes())
        return f"{name}-{h.hexdigest()[:12]}"

    def _path(self, fp: str, sig: str) -> Path:
        digest = hashlib.sha1(f"{fp}|{sig}".encode()).hexdigest()[:16]
        safe = "".join(c if c.isalnum() or c in "._-" else "_" for c in fp)
        return self.root / f"{safe[:48]}_{digest}.npz"

    def get_or_pack(self, name: str, coo: COOMatrix, cfg: SpmmConfig,
                    fmt: str, reorder_cols: bool = False,
                    reorder_rows: bool = False):
        """Return the packed matrix, from memory, disk, or a fresh pack.

        The returned object carries the caller's full ``cfg`` (kernel knobs
        included), not the config stored on disk.
        """
        sig = pack_signature(cfg, fmt, reorder_cols, reorder_rows)
        fp = self._fingerprint(name, coo)
        if fp != self._mem_fp:
            # moving to a new matrix: drop the old one's packs (full-suite
            # passes would otherwise hold GBs of packed arrays in RSS; the
            # disk layer keeps cross-matrix reuse)
            self._mem.clear()
            self._mem_fp = fp
        mkey = (fp, sig)
        if mkey in self._mem:
            self.hits += 1
            return self._with_cfg(self._mem[mkey], cfg)
        path = self._path(fp, sig)
        raw_dir = path.with_suffix(".raw")
        if raw_dir.is_dir():
            try:
                packed = _raw_load(raw_dir, fmt)
                self._mem[mkey] = packed
                self.disk_hits += 1
                return self._with_cfg(packed, cfg)
            except Exception:
                pass  # corrupt/partial dir: fall through
        if path.exists():
            try:
                packed = _load_fmt(path, fmt)
                self._mem[mkey] = packed
                self.disk_hits += 1
                return self._with_cfg(packed, cfg)
            except Exception:
                pass  # corrupt/stale file: fall through to re-pack
        self.misses += 1
        packed = _pack_fmt(coo, cfg, fmt, reorder_cols, reorder_rows)
        raw_limit = int(
            os.environ.get("SEXTANS_PACK_RAW_BYTES", RAW_BYTES_DEFAULT)
        )
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            if _packed_nbytes(packed) > raw_limit:
                _raw_save(packed, raw_dir)
            else:
                tmp = path.with_suffix(".tmp.npz")
                packed.save(tmp)
                os.replace(tmp, path)  # atomic: concurrent passes never corrupt
        except OSError:
            pass  # disk cache is an optimization; never fail the pack
        self._mem[mkey] = packed
        return packed

    def get_or_split(self, name: str, coo: COOMatrix, *, n=None, **params):
        """Memoized ``ops.hybrid.split_structure``: the structure
        decomposition costs minutes of host scatter work on 10M+-edge
        matrices and is re-run per (matrix, N) benchmark row. Keyed by the
        matrix fingerprint, ``n``, any non-default split params, and
        ``SPLIT_VERSION`` (algorithm changes invalidate cached splits)."""
        from sextans_tpu.ops.hybrid import (
            SPLIT_VERSION,
            HybridSplit,
            split_structure,
        )

        extras = "|".join(f"{k}={params[k]}" for k in sorted(params))
        sig = f"split|v{SPLIT_VERSION}|n={n}|{extras}"
        fp = self._fingerprint(name, coo)
        if fp != self._mem_fp:
            self._mem.clear()
            self._mem_fp = fp
        mkey = (fp, sig)
        if mkey in self._mem:
            self.hits += 1
            return self._mem[mkey]
        path = self._path(fp, sig)
        if path.exists():
            try:
                split = HybridSplit.load(path)
                self._mem[mkey] = split
                self.disk_hits += 1
                return split
            except Exception:
                pass  # corrupt/stale file: fall through to re-split
        self.misses += 1
        split = split_structure(coo, n=n, **params)
        try:
            self.root.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(".tmp.npz")
            split.save(tmp)
            os.replace(tmp, path)
        except OSError:
            pass
        self._mem[mkey] = split
        return split
