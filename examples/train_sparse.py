"""Training-style demo: learn A's values through the differentiable SpMM.

Recovers the values of a sparse matrix from (B, C_target) pairs by gradient
descent on ||alpha*A(vals)@B + beta*C0 - C_target||^2 — the SDDMM gradient
path (ops/autodiff.py): dvals = alpha * (G @ B^T) sampled at A's pattern.
The reference accelerator has no training story; this is the capability a
JAX-native design adds for free (SURVEY.md §7 "beyond-reference").

Usage: python examples/train_sparse.py    (CPU or GPU; small shapes)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

import sextans_tpu as sx


def main():
    rng = np.random.default_rng(0)
    m, k, n, nnz = 256, 192, 32, 2000
    a_true = sx.COOMatrix.random(m, k, nnz, seed=1)
    cfg = sx.SpmmConfig(tile_m=64, window_k=64, block_k=8, group_blocks=16)
    # structure is fixed; values are the learned parameter
    op = sx.spmm_value_op(a_true, n, config=cfg)

    b = jnp.asarray(rng.standard_normal((k, n)).astype(np.float32))
    c0 = jnp.asarray(rng.standard_normal((m, n)).astype(np.float32))
    alpha, beta = jnp.float32(1.0), jnp.float32(0.5)
    target = op(jnp.asarray(a_true.vals), b, c0, alpha, beta)

    import optax

    @jax.jit
    def loss_fn(vals):
        pred = op(vals, b, c0, alpha, beta)
        return jnp.mean((pred - target) ** 2)

    vals = jnp.zeros(a_true.nnz, jnp.float32)  # start from nothing
    opt = optax.adam(0.1)
    opt_state = opt.init(vals)

    @jax.jit
    def train_step(vals, opt_state):
        loss, g = jax.value_and_grad(loss_fn)(vals)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(vals, updates), opt_state, loss

    for step in range(300):
        vals, opt_state, loss = train_step(vals, opt_state)
        if step % 50 == 0:
            print(f"step {step:3d}  loss {float(loss):.3e}")
    err = float(jnp.max(jnp.abs(vals - jnp.asarray(a_true.vals))))
    print(f"final loss {float(loss_fn(vals)):.3e}, max |vals - true| = {err:.3e}")
    assert float(loss_fn(vals)) < 1e-4
    print("recovered A's values through the SDDMM gradient — OK")


if __name__ == "__main__":
    main()
