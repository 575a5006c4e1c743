"""End-to-end demo: C = alpha*A*B + beta*C from a Matrix Market file.

Usage:  python examples/demo.py [matrix.mtx]   (defaults to the reference's
nasa4704 sample if the read-only mount is present)
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

import sextans_tpu as sx

DEFAULT = "/root/reference/matrices/nasa4704/nasa4704.mtx"


def main():
    path = sys.argv[1] if len(sys.argv) > 1 else DEFAULT
    if not Path(path).exists():
        print("no matrix file; synthesizing a random banded one")
        a = sx.COOMatrix.random(4096, 4096, 100_000, seed=0, banded=True)
    else:
        a = sx.read_mtx(path)
    m, k = a.shape
    n = 256
    print(f"A: {m} x {k}, nnz={a.nnz}")

    # 1. pick a config for this sparsity pattern and pack (host, once)
    cfg = sx.SpmmConfig()  # or: sextans_tpu.utils.autotune.choose_config(a)[0].config
    t0 = time.perf_counter()
    packed = sx.pack(a, cfg)
    print(
        f"packed in {time.perf_counter()-t0:.2f}s: "
        f"{packed.stats.blocks} blocks, fill {packed.stats.block_fill:.2f}"
    )

    # 2. build a device-resident plan (compiles once per (matrix, N))
    plan = sx.plan(packed, n)

    # 3. run
    rng = np.random.default_rng(0)
    b = rng.standard_normal((k, n)).astype(np.float32)
    c = rng.standard_normal((m, n)).astype(np.float32)
    out = np.asarray(plan(b, alpha=0.85, beta=-2.06, c=c))

    # 4. check against the golden model
    ref = sx.golden_spmm(sx.CSRMatrix.from_coo(a), b, 0.85, -2.06, c)
    print(sx.verify(ref, out))

    # 5. the format the analytic autotuner picks for this matrix; the
    #    dense-slab format when it wins the byte model
    from sextans_tpu.utils.autotune import choose_backend

    best = choose_backend(a, n=n)[0]
    print(f"autotuner pick: {best.fmt} {best.config}")
    if best.fmt == "mxu":
        packed_mxu = sx.pack_mxu(a, best.config)
        out2 = np.asarray(sx.plan(packed_mxu, n)(b, 0.85, -2.06, c))
        print("mxu engine:", sx.verify(ref, out2))

    # 5b. the structure-independent edge-stream engine: ~8 B/nnz packed
    #     size regardless of sparsity pattern (the reference's own
    #     edge-stream economics) — the fallback where block fill collapses
    packed_edge = sx.pack_edge(a, sx.SpmmConfig(tile_m=1024, window_k=2048))
    out3 = np.asarray(sx.plan(packed_edge, n)(b, 0.85, -2.06, c))
    print("edge engine:", sx.verify(ref, out3),
          f"({packed_edge.stats.bytes_per_nnz:.1f} B/nnz)")

    # 6. hybrid structure split, for stencil/power-law matrices:
    #    diagonals + dense hub columns/rows + blocked residue
    split = sx.split_structure(a)
    print(split.summary())

    # 7. gradients, if you need them
    import jax

    op = sx.spmm_op(a, n, alpha=1.0, beta=0.0)
    loss = lambda bb: op(jax.numpy.asarray(bb), jax.numpy.zeros((m, n))).sum()  # noqa: E731
    g = jax.grad(loss)(b)
    print(f"dLoss/dB computed: {np.asarray(g).shape}")


if __name__ == "__main__":
    main()
