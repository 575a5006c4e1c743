"""Device-side full-matrix verification for huge outputs.

The reference host verifies EVERY element of C against a CPU golden
(sextans-host.cpp:262-290). For outputs where C exceeds ~0.5 GB a host-side
check would fetch gigabytes; a stratified sample is statistically strong
but not the reference's full-matrix guarantee. This module keeps it
without the host round-trip: the f64 oracle runs ON DEVICE in bounded
blocks, and only two scalars per block (max|got - exact| and max|exact|)
cross the wire.

Per M-block the check gathers the block's edges, recomputes
``alpha * A_block @ B + beta * C_block`` in float64, and
reduces the elementwise error against the kernel's resident f32 output.
Edges are processed in fixed-size chunks through ``lax.map`` so the
gathered (chunk, n) f64 intermediate stays bounded; chunk counts are
padded to the next power of two so the jit cache holds O(log nnz) entries
rather than one per block.

Independence: the oracle path shares no code with any kernel engine — it
is stock XLA gather + segment-sum in a different precision, the device
twin of ops/golden.golden_spmm_exact.
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np

__all__ = ["device_full_check"]


def _next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@partial(jax.jit, static_argnames=("block_rows", "edge_chunk", "with_c"))
def _check_block(
    r_local,  # (n_chunks, edge_chunk) i32 — row-in-block; block_rows = pad
    cols,  # (n_chunks, edge_chunk) i32 — B row per edge (0 for pads)
    vals64,  # (n_chunks, edge_chunk) f64 — edge values (0 for pads)
    b32,  # (k, n) f32 — the SAME device B the kernel used; gathered rows
    #       are widened AFTER the gather (f32 -> f64 is exact), so no f64
    #       copy of B ever materializes (4.5 GB at K=1M, N=512 — the
    #       round-4 pass-3 OOM)
    c_block,  # (block_rows, n) f32 — C input rows of this block
    got_block,  # (block_rows, n) f32 — kernel output rows of this block
    alpha64,
    beta64,
    *,
    block_rows: int,
    edge_chunk: int,
    with_c: bool,
):
    import jax
    import jax.numpy as jnp

    def chunk_add(carry, args):
        rl, cl, vl = args
        gathered = (
            jnp.take(b32, cl, axis=0).astype(jnp.float64) * vl[:, None]
        )  # (chunk, n) f64 — the only f64 transient, one chunk at a time
        # pads carry vals64 == 0 and r_local == block_rows: the sentinel
        # segment is sliced away below, and 0 * B[0] is exact for finite B
        return carry + jax.ops.segment_sum(
            gathered, rl, num_segments=block_rows + 1,
            indices_are_sorted=True,
        ), None

    ab_full, _ = jax.lax.scan(
        chunk_add,
        jnp.zeros((block_rows + 1, b32.shape[1]), jnp.float64),
        (r_local, cols, vals64),
    )
    ab = ab_full[:block_rows]  # (block_rows, n) f64
    exact = alpha64 * ab
    if with_c:
        exact = exact + beta64 * c_block.astype(jnp.float64)
    err = jnp.max(jnp.abs(got_block.astype(jnp.float64) - exact))
    return err, jnp.max(jnp.abs(exact))


def device_full_check(
    got_dev,  # (m, n) device array — the kernel result to verify
    csr,  # CSRMatrix — the operand in row-sorted form
    b: np.ndarray,  # (k, n) f32
    alpha: float,
    beta: float,
    c,  # (m, n) f32 or None
    block_rows: int = 65536,
    edge_chunk: int = 131072,
) -> dict:
    """Full-matrix device-side check of ``got_dev`` against the f64 oracle.

    Returns ``{"max_abs_vs_f64", "c_max_abs", "blocks"}`` where
    ``max_abs_vs_f64`` is the exact full-matrix max-abs error (every
    element checked on device) and ``c_max_abs`` is max|exact| for the
    ulp normalization. Host traffic: two scalars per M-block. Device
    footprint is bounded: B stays f32 (pass the kernel's own device copy
    to avoid any duplicate), and the f64 transients are one
    (edge_chunk, n) gather plus one (block_rows+1, n) scan carry.
    """
    import jax
    import jax.numpy as jnp

    m, n = csr.shape[0], b.shape[1]
    if getattr(got_dev, "shape", None) != (m, n):
        raise ValueError(
            f"got_dev must be ({m}, {n}), got {getattr(got_dev, 'shape', None)}"
        )
    with jax.enable_x64(True):
        b32 = jnp.asarray(b, dtype=jnp.float32)
        # widen the f32 scalars the kernels actually consume, not the f64
        # literals (see golden_spmm_exact's alpha/beta note)
        a64 = jnp.float64(np.float32(alpha))
        bt64 = jnp.float64(np.float32(beta))
        with_c = c is not None and float(beta) != 0.0
        err = 0.0
        cmax = 0.0
        blocks = 0
        for start in range(0, m, block_rows):
            rows = min(block_rows, m - start)
            lo = int(csr.indptr[start])
            hi = int(csr.indptr[start + rows])
            ne = hi - lo
            n_chunks = max(1, _next_pow2(-(-max(ne, 1) // edge_chunk)))
            cap = n_chunks * edge_chunk
            r_local = np.full(cap, block_rows, dtype=np.int32)
            cols_p = np.zeros(cap, dtype=np.int32)
            vals_p = np.zeros(cap, dtype=np.float64)
            if ne:
                lens = np.diff(csr.indptr[start : start + rows + 1])
                r_local[:ne] = np.repeat(
                    np.arange(rows, dtype=np.int32), lens
                )
                cols_p[:ne] = csr.indices[lo:hi]
                vals_p[:ne] = csr.vals[lo:hi]
            if start + block_rows <= m:
                got_blk = jax.lax.dynamic_slice_in_dim(
                    got_dev, start, block_rows, 0
                )
            else:
                # ragged tail: zero-pad ON DEVICE (pad rows have no edges
                # and a zero C, so exact == 0 there and the error term
                # vanishes; nothing big crosses the wire)
                got_blk = jnp.pad(
                    got_dev[start:], ((0, block_rows - rows), (0, 0))
                )
            if with_c:
                c_blk = np.zeros((block_rows, n), dtype=np.float32)
                c_blk[:rows] = c[start : start + rows]
                c_blk = jnp.asarray(c_blk)
            else:
                c_blk = jnp.zeros((block_rows, n), jnp.float32)
            e, cm = _check_block(
                jnp.asarray(r_local.reshape(n_chunks, edge_chunk)),
                jnp.asarray(cols_p.reshape(n_chunks, edge_chunk)),
                jnp.asarray(vals_p.reshape(n_chunks, edge_chunk)),
                b32, c_blk, got_blk, a64, bt64,
                block_rows=block_rows, edge_chunk=edge_chunk,
                with_c=with_c,
            )
            err = max(err, float(e))
            cmax = max(cmax, float(cm))
            blocks += 1
    return {"max_abs_vs_f64": err, "c_max_abs": cmax, "blocks": blocks}
