"""Plain-XLA SpMM engines over the block, dense-slab and edge formats.

All three formats describe A as a list of small dense blocks, each with a
first output row and a first B row:

* block format (format/pack.py): 8 x block_k blocks, ``vals`` laid out
  (groups, 8, G*bk);
* dense-slab format (format/pack_mxu.py): block_k x 128 slabs stored
  k-major, ``vals`` laid out (groups, G*bk, 128);
* edge format (format/pack_edge.py): 1 x 1 blocks, one per nonzero, with
  row and column decoded from the packed ``meta`` word.

Each engine is one batched gather of the blocks' B rows, one contraction
per block at ``Precision.HIGHEST`` (a default float32 contraction may run in
TF32 on the GPU, which fails the 1e-4 gate) and one scatter-add of the
block results into the output rows. The blocks are processed in a few large
chunks (``lax.scan``) so the gathered and per-block intermediates stay near
``CHUNK_BYTES`` whatever the matrix size; a per-group loop would be one
small launch per group on the GPU.

Padding blocks point at row ``m_padded``, which the scatter drops, so they
contribute nothing even where B holds Inf or NaN.

``precise`` accumulates in float64 (native on the GPU and CPU) and rounds
once in the alpha/beta epilogue; it needs x64 enabled at trace time
(``SpmmPlan`` enables it around precise calls).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from sextans_tpu.format.pack_edge import COL_SHIFT, PAD_BIT, ROW_SHIFT
from sextans_tpu.utils.config import cdiv

__all__ = [
    "spmm_xla_padded",
    "spmm_slab_padded",
    "spmm_edge_padded",
    "acc_dtype",
    "CHUNK_BYTES",
]

# Target size of one chunk's gathered-B plus per-block-result intermediates.
CHUNK_BYTES = 256 * 1024 * 1024


def acc_dtype(precise) -> jnp.dtype:
    """float64 for precise calls (x64 must be on), float32 otherwise."""
    if not precise:
        return jnp.float32
    if jax.dtypes.canonicalize_dtype(np.float64) != np.float64:
        raise ValueError(
            "precise SpMM accumulates in float64: enable x64 "
            "(jax.enable_x64) around the call, as SpmmPlan does"
        )
    return jnp.float64


def _accumulate_blocks(vblk, row0, col0, b, m_out, *, spec, rpb, bk, acc_dt):
    """sum over blocks of contract(vblk[i], B[col0[i]:col0[i]+bk]) scattered
    into rows row0[i]:row0[i]+rpb of an (m_out, n) accumulator.

    ``spec`` is the einsum of one chunk: block values x gathered B rows
    (c, bk, n) -> (c, rpb, n). Rows >= m_out are dropped."""
    nb = vblk.shape[0]
    n = b.shape[1]
    per_block = 4 * n * (rpb + bk) * (2 if acc_dt == jnp.float64 else 1)
    cb = max(1, min(nb, CHUNK_BYTES // max(per_block, 1)))
    steps = cdiv(nb, cb)
    pad = steps * cb - nb
    if pad:
        vblk = jnp.pad(vblk, ((0, pad),) + ((0, 0),) * (vblk.ndim - 1))
        row0 = jnp.pad(row0, (0, pad), constant_values=m_out)
        col0 = jnp.pad(col0, (0, pad))
    xs = (
        vblk.reshape((steps, cb) + vblk.shape[1:]),
        row0.reshape(steps, cb),
        col0.reshape(steps, cb),
    )
    k_iota = jnp.arange(bk, dtype=jnp.int32)
    r_iota = jnp.arange(rpb, dtype=jnp.int32)

    def step(acc, x):
        v, r0, c0 = x
        brows = jnp.take(b, c0[:, None] + k_iota[None, :], axis=0,
                         mode="clip")  # (cb, bk, n)
        contrib = jnp.einsum(
            spec,
            v.astype(acc_dt),
            brows.astype(acc_dt),
            preferred_element_type=acc_dt,
            precision=jax.lax.Precision.HIGHEST,
        )  # (cb, rpb, n)
        rows = r0[:, None] + r_iota[None, :]
        return acc.at[rows].add(contrib, mode="drop"), None

    acc0 = jnp.zeros((m_out, n), acc_dt)
    if steps == 1:
        acc, _ = step(acc0, jax.tree.map(lambda a: a[0], xs))
        return acc
    acc, _ = jax.lax.scan(step, acc0, xs)
    return acc


def _epilogue(ab, c_padded, alpha, beta, with_c, acc_dt):
    out = alpha.astype(acc_dt) * ab
    if with_c:
        out = out + beta.astype(acc_dt) * c_padded.astype(acc_dt)
    return out.astype(jnp.float32)


def _group_origin(group_mtile, group_kwin, ngroups, tile_m, window_k):
    gmt = group_mtile[:ngroups]
    return gmt * tile_m, group_kwin * window_k


@partial(
    jax.jit,
    static_argnames=(
        "tile_m", "window_k", "block_k", "group_blocks", "with_c", "precise",
    ),
)
def spmm_xla_padded(
    vals: jax.Array,  # (ngroups, 8, G*bk) f32
    qrow: jax.Array,  # (ngroups, G) i32 — 8-row stripe within the M-tile
    bcol: jax.Array,  # (ngroups, G) i32 — k offset within the K-window
    group_mtile: jax.Array,  # (ngroups+1,) i32
    group_kwin: jax.Array,  # (ngroups,) i32
    b_padded: jax.Array,  # (k_padded, n) f32
    c_padded: jax.Array,  # (m_padded, n) f32
    alpha: jax.Array,
    beta: jax.Array,
    *,
    tile_m: int,
    window_k: int,
    block_k: int,
    group_blocks: int,
    with_c: bool = True,
    precise: int = 0,
) -> jax.Array:
    """alpha * A @ B + beta * C over the 8 x block_k block format; returns
    the padded (m_padded, n) result."""
    acc_dt = acc_dtype(precise)
    ngroups = vals.shape[0]
    G, bk = group_blocks, block_k
    m_padded = c_padded.shape[0]
    vblk = (
        vals.reshape(ngroups, 8, G, bk).transpose(0, 2, 1, 3)
        .reshape(ngroups * G, 8, bk)
    )
    m0, k0 = _group_origin(group_mtile, group_kwin, ngroups, tile_m, window_k)
    row0 = (m0[:, None] + 8 * qrow).reshape(-1)
    col0 = (k0[:, None] + bcol).reshape(-1)
    ab = _accumulate_blocks(
        vblk, row0, col0, b_padded, m_padded,
        spec="crk,ckn->crn", rpb=8, bk=bk, acc_dt=acc_dt,
    )
    return _epilogue(ab, c_padded, alpha, beta, with_c, acc_dt)


@partial(
    jax.jit,
    static_argnames=(
        "tile_m", "window_k", "block_k", "group_blocks", "with_c", "precise",
    ),
)
def spmm_slab_padded(
    vals: jax.Array,  # (ngroups, G*bk, 128) f32 — slabs stored k-major
    qm: jax.Array,  # (ngroups, G) i32 — 128-row slab within the M-tile
    bcol: jax.Array,  # (ngroups, G) i32
    group_mtile: jax.Array,
    group_kwin: jax.Array,
    b_padded: jax.Array,
    c_padded: jax.Array,
    alpha: jax.Array,
    beta: jax.Array,
    *,
    tile_m: int,
    window_k: int,
    block_k: int,
    group_blocks: int,
    with_c: bool = True,
    precise: int = 0,
) -> jax.Array:
    """alpha * A @ B + beta * C over the block_k x 128 dense-slab format."""
    from sextans_tpu.format.pack_mxu import MSLAB

    acc_dt = acc_dtype(precise)
    ngroups = vals.shape[0]
    G, bk = group_blocks, block_k
    m_padded = c_padded.shape[0]
    vblk = vals.reshape(ngroups * G, bk, MSLAB)
    m0, k0 = _group_origin(group_mtile, group_kwin, ngroups, tile_m, window_k)
    row0 = (m0[:, None] + MSLAB * qm).reshape(-1)
    col0 = (k0[:, None] + bcol).reshape(-1)
    ab = _accumulate_blocks(
        vblk, row0, col0, b_padded, m_padded,
        spec="ckr,ckn->crn", rpb=MSLAB, bk=bk, acc_dt=acc_dt,
    )
    return _epilogue(ab, c_padded, alpha, beta, with_c, acc_dt)


@partial(
    jax.jit, static_argnames=("tile_m", "window_k", "with_c", "precise")
)
def spmm_edge_padded(
    vals: jax.Array,  # (chunks, 1, E) f32
    meta: jax.Array,  # (chunks, 1, E) i32 — packed row/col/flags per edge
    chunk_mtile: jax.Array,  # (chunks+1,) i32
    chunk_kwin: jax.Array,  # (chunks,) i32
    b_padded: jax.Array,
    c_padded: jax.Array,
    alpha: jax.Array,
    beta: jax.Array,
    *,
    tile_m: int,
    window_k: int,
    with_c: bool = True,
    precise: int = 0,
) -> jax.Array:
    """alpha * A @ B + beta * C over the edge format: a gather of one B row
    per nonzero and a scatter-add into its output row."""
    acc_dt = acc_dtype(precise)
    nchunks = vals.shape[0]
    m_padded = c_padded.shape[0]
    m0, k0 = _group_origin(chunk_mtile, chunk_kwin, nchunks, tile_m, window_k)
    meta2 = meta.reshape(nchunks, -1)
    col_mask = (1 << (ROW_SHIFT - COL_SHIFT)) - 1
    row = m0[:, None] + (meta2 >> ROW_SHIFT)
    row = jnp.where((meta2 & PAD_BIT) != 0, m_padded, row)
    col = k0[:, None] + ((meta2 >> COL_SHIFT) & col_mask)
    ab = _accumulate_blocks(
        vals.reshape(-1, 1, 1), row.reshape(-1), col.reshape(-1),
        b_padded, m_padded,
        spec="crk,ckn->crn", rpb=1, bk=1, acc_dt=acc_dt,
    )
    return _epilogue(ab, c_padded, alpha, beta, with_c, acc_dt)
