"""Matrix Market (``.mtx``) I/O.

Re-implementation of the capabilities of the reference's vendored
NIST ``mmio.h`` reader (reference: src/mmio.h:254,339,488) and the SuiteSparse
loading semantics of ``load_S_matrix`` / ``read_suitsparse_matrix``
(reference: src/sparse_helper.h:112-259):

* coordinate format only (``array`` format rejected, like the reference host);
* ``real`` / ``integer`` values parsed as float32; ``pattern`` entries get
  value 1.0 (src/sparse_helper.h:136-138); ``complex`` rejected
  (src/sparse_helper.h:120-123);
* entries whose float32 bit pattern is exactly +0.0 are dropped
  (src/sparse_helper.h:143-145 drops ``uint_v == 0``; note ``-0.0`` has a
  nonzero bit pattern and is therefore *kept*, matching the reference);
* ``symmetric`` matrices are mirror-expanded, off-diagonal entries duplicated
  transposed (src/sparse_helper.h:156-163); we additionally support
  ``skew-symmetric`` (negated mirror), which the reference silently treats as
  general — a documented improvement, not a behavior change for the
  SuiteSparse FEM suite;
* 1-based Matrix Market indices converted to 0-based; out-of-range indices
  raise (src/sparse_helper.h:146-149 exits).

Parsing is vectorized NumPy (single ``fromstring`` pass over the payload)
rather than a per-line ``fscanf`` loop, since this front end runs on the host
CPU feeding the device.
"""

from __future__ import annotations

import gzip
import warnings
from dataclasses import dataclass
from pathlib import Path
from typing import Union

import numpy as np

__all__ = ["MtxHeader", "read_mtx", "read_mtx_coo", "write_mtx"]

_VALID_FIELDS = ("real", "integer", "pattern", "complex")
_VALID_SYMMETRIES = ("general", "symmetric", "skew-symmetric", "hermitian")


@dataclass(frozen=True)
class MtxHeader:
    """Parsed ``%%MatrixMarket`` banner + size line."""

    object: str  # "matrix"
    format: str  # "coordinate" | "array"
    field: str  # "real" | "integer" | "pattern" | "complex"
    symmetry: str  # "general" | "symmetric" | "skew-symmetric" | "hermitian"
    nrows: int
    ncols: int
    nnz_stored: int  # entries stored in the file (pre mirror-expansion)


def _open(path: Union[str, Path]):
    path = Path(path)
    if path.suffix == ".gz":
        return gzip.open(path, "rb")
    return open(path, "rb")


def _parse_banner(line: bytes) -> tuple[str, str, str, str]:
    parts = line.decode("ascii", errors="replace").strip().split()
    if len(parts) < 5 or parts[0] != "%%MatrixMarket":
        raise ValueError(f"not a Matrix Market file (banner: {line[:80]!r})")
    _, obj, fmt, field, sym = (p.lower() for p in parts[:5])
    if obj != "matrix":
        raise ValueError(f"unsupported MatrixMarket object {obj!r}")
    if field not in _VALID_FIELDS:
        raise ValueError(f"unsupported MatrixMarket field {field!r}")
    if sym not in _VALID_SYMMETRIES:
        raise ValueError(f"unsupported MatrixMarket symmetry {sym!r}")
    return obj, fmt, field, sym


def read_header(path: Union[str, Path]) -> MtxHeader:
    """Read only the banner and size line (cheap metadata probe)."""
    with _open(path) as f:
        banner = f.readline()
        obj, fmt, field, sym = _parse_banner(banner)
        size_line = f.readline()
        while size_line.startswith(b"%") or not size_line.strip():
            size_line = f.readline()
        dims = size_line.split()
        if fmt == "coordinate":
            nrows, ncols, nnz = int(dims[0]), int(dims[1]), int(dims[2])
        else:  # array
            nrows, ncols = int(dims[0]), int(dims[1])
            nnz = nrows * ncols
        return MtxHeader(obj, fmt, field, sym, nrows, ncols, nnz)


def read_mtx_coo(
    path: Union[str, Path],
    *,
    expand_symmetry: bool = True,
    drop_explicit_zeros: bool = True,
    dtype=np.float32,
) -> tuple[MtxHeader, np.ndarray, np.ndarray, np.ndarray]:
    """Read a coordinate Matrix Market file into 0-based COO arrays.

    Returns ``(header, rows, cols, vals)`` with ``rows``/``cols`` as int32 and
    ``vals`` as ``dtype``. Symmetric inputs are mirror-expanded when
    ``expand_symmetry`` (reference: src/sparse_helper.h:156-163); stored
    entries whose value is bitwise +0.0 are dropped when
    ``drop_explicit_zeros`` (src/sparse_helper.h:143-145).
    """
    with _open(path) as f:
        banner = f.readline()
        _, fmt, field, sym = _parse_banner(banner)
        if fmt != "coordinate":
            raise ValueError(
                "only coordinate Matrix Market files are supported "
                "(matching the reference host, src/sparse_helper.h:188-191)"
            )
        if field == "complex":
            raise ValueError(
                "complex matrices are not supported "
                "(matching the reference, src/sparse_helper.h:120-123)"
            )
        payload = f.read()

    # Strip comment lines (rare mid-file '%' comments are legal).
    if b"%" in payload:
        lines = [ln for ln in payload.split(b"\n") if not ln.lstrip().startswith(b"%")]
        payload = b"\n".join(lines)

    text = payload.decode("ascii", errors="replace")
    if "\r" in text[:4096]:  # Windows line endings would break fromstring
        text = text.replace("\r", " ")
    # Find the size line (first non-blank line).
    idx = 0
    n = len(text)
    while idx < n:
        end = text.find("\n", idx)
        if end == -1:
            end = n
        line = text[idx:end].strip()
        if line:
            break
        idx = end + 1
    dims = line.split()
    nrows, ncols, nnz_stored = int(dims[0]), int(dims[1]), int(dims[2])
    header = MtxHeader("matrix", fmt, field, sym, nrows, ncols, nnz_stored)
    body = text[end + 1 :] if end < n else ""

    tokens_per_entry = 2 if field == "pattern" else 3
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        data = np.fromstring(body, dtype=np.float64, sep=" ")  # fast C parse
    if data.size < nnz_stored * tokens_per_entry:
        raise ValueError(
            f"truncated mtx file: expected {nnz_stored} entries "
            f"({nnz_stored * tokens_per_entry} tokens), got {data.size} tokens"
        )
    data = data[: nnz_stored * tokens_per_entry].reshape(nnz_stored, tokens_per_entry)

    rows = data[:, 0].astype(np.int64)
    cols = data[:, 1].astype(np.int64)
    if field == "pattern":
        vals = np.ones(nnz_stored, dtype=dtype)
    else:
        vals = data[:, 2].astype(dtype)

    if np.any(rows < 1) or np.any(cols < 1):
        bad = int(np.argmax((rows < 1) | (cols < 1)))
        raise ValueError(
            f"1-based index out of range at entry {bad}: "
            f"({rows[bad]}, {cols[bad]}) (reference exits, src/sparse_helper.h:146-149)"
        )
    if np.any(rows > nrows) or np.any(cols > ncols):
        raise ValueError("index exceeds declared matrix dimensions")
    rows -= 1
    cols -= 1

    if drop_explicit_zeros and field != "pattern":
        # Reference drops entries whose float32 *bit pattern* is zero, which
        # keeps -0.0 (src/sparse_helper.h:143-145).
        keep = vals.astype(np.float32).view(np.uint32) != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]

    if expand_symmetry and sym in ("symmetric", "skew-symmetric", "hermitian"):
        off_diag = rows != cols
        mirror_rows = cols[off_diag]
        mirror_cols = rows[off_diag]
        mirror_vals = vals[off_diag]
        if sym == "skew-symmetric":
            mirror_vals = -mirror_vals
        rows = np.concatenate([rows, mirror_rows])
        cols = np.concatenate([cols, mirror_cols])
        vals = np.concatenate([vals, mirror_vals])

    return header, rows.astype(np.int32), cols.astype(np.int32), vals.astype(dtype)


def read_mtx(path: Union[str, Path], **kwargs):
    """Read a Matrix Market file into a :class:`~sextans_tpu.format.coo.COOMatrix`."""
    from sextans_tpu.format.coo import COOMatrix

    header, rows, cols, vals = read_mtx_coo(path, **kwargs)
    return COOMatrix(
        shape=(header.nrows, header.ncols), rows=rows, cols=cols, vals=vals
    )


def write_mtx(path: Union[str, Path], coo, *, comment: str = "") -> None:
    """Write a COO matrix as a general real coordinate Matrix Market file."""
    path = Path(path)
    with open(path, "w") as f:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{coo.shape[0]} {coo.shape[1]} {coo.nnz}\n")
        # vectorized body: np.savetxt writes ~10^6 lines/s vs ~10^5 for a
        # Python loop — SuiteSparse-scale outputs need it
        if coo.nnz:
            np.savetxt(
                f,
                np.column_stack(
                    (
                        coo.rows.astype(np.int64) + 1,
                        coo.cols.astype(np.int64) + 1,
                        coo.vals.astype(np.float64),
                    )
                ),
                fmt="%d %d %.9g",
            )
