"""Command-line interface — parity with the reference host binary.

Reference usage (src/sextans-host.cpp:26-48)::

    ./sextans [matrix A file] [N] [rp_time] [alpha] [beta]

Here::

    python -m sextans_tpu [matrix A file] [N] [rp_time] [alpha] [beta] [--backend ...]

Same positional semantics, same synthesized B (all 1.0, src/sextans-host.cpp:100-104)
and C ((m+1)(n+1)/M/N, src/sextans-host.cpp:107-111), same defaults
alpha=0.85 beta=-2.06 rp_time=1 (src/sextans-host.cpp:29-31), same GFLOPS
formula and Success!/Failed verification report (src/sextans-host.cpp:253-290).
N is rounded up to a multiple of 8 like tapa::round_up<8> (src/sextans-host.cpp:51).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from sextans_tpu.format.csr import CSRMatrix
from sextans_tpu.format.pack import pack
from sextans_tpu.io.mtx import read_mtx
from sextans_tpu.ops.golden import golden_spmm
from sextans_tpu.utils.config import SpmmConfig, round_up
from sextans_tpu.utils.verify import gflops, verify


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="sextans_tpu",
        description="SpMM in JAX: C = alpha*A*B + beta*C over Matrix Market inputs",
    )
    p.add_argument("matrix", help="Matrix Market (.mtx/.mtx.gz) sparse A file")
    p.add_argument("N", type=int, help="dense columns (rounded up to multiple of 8)")
    p.add_argument("rp_time", type=int, nargs="?", default=1, help="kernel repeats for timing")
    p.add_argument("alpha", type=float, nargs="?", default=0.85)
    p.add_argument("beta", type=float, nargs="?", default=-2.06)
    p.add_argument(
        "--backend",
        default="auto",
        choices=["auto", "xla", "mxu", "edge", "ell", "ell_triton"],
        help="engine, which also picks the pack format: xla = 8 x block_k "
        "blocks; mxu = block_k x 128 dense slabs; edge = one record per "
        "nonzero; ell / ell_triton (GPU only) = R slots per row; auto = the "
        "block format with the platform's engine (ops/engines.py)",
    )
    p.add_argument(
        "--precise",
        action="store_true",
        help="float64 accumulation with one rounding to float32 (within "
        "~1 ulp of the float64 oracle; see docs/ACCURACY.md)",
    )
    p.add_argument(
        "--hybrid",
        action="store_true",
        help="structure-split execution: diagonals + dense head columns + "
        "blocked residue (best for stencil/power-law matrices)",
    )
    p.add_argument("--tile-m", type=int, default=None)
    p.add_argument("--window-k", type=int, default=None)
    p.add_argument("--block-k", type=int, default=None)
    p.add_argument("--group-blocks", type=int, default=None)
    p.add_argument("--skip-cpu", action="store_true", help="skip the golden CPU run")
    p.add_argument("--save-packed", default=None, help="save packed A to .npz")
    p.add_argument(
        "--reorder-cols",
        action="store_true",
        help="degree-sort columns before packing (helps power-law matrices)",
    )
    p.add_argument(
        "--reorder-rows",
        action="store_true",
        help="degree-sort rows before packing; with --reorder-cols this is "
        "the 2-D degree reorder clustering the power-law hub core into "
        "dense blocks (C rows are permuted at the plan boundary)",
    )
    p.add_argument(
        "--autotune",
        action="store_true",
        help="pick block_k/group size analytically from the sparsity pattern",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=None,
        metavar="S",
        help="multi-device execution over an S-device mesh (row-block or "
        "K-sharded)",
    )
    p.add_argument(
        "--shard-mode",
        default="row",
        choices=["row", "k"],
        help="row = A/C row-sharded, B replicated (zero collectives); "
        "k = A column-slab sharded with a psum_scatter of C partials",
    )
    p.add_argument(
        "--shard-balance",
        default="nnz",
        choices=["nnz", "contiguous"],
        help="row-mode shard assignment: nnz = LPT-balanced m-tiles "
        "(the row%%64 PE-interleave analog), contiguous = equal row slabs",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    print("start host")

    n = round_up(args.N, 8)
    print(f"N = {n}")
    print(f"alpha = {args.alpha}")
    print(f"beta = {args.beta}")

    print("Reading sparse A matrix...", flush=True)
    coo = read_mtx(args.matrix)
    m, k = coo.shape
    nnz = coo.nnz
    print("done")
    print("Matrix size:")
    print(f"A: sparse matrix, {m} x {k}. NNZ = {nnz}")
    print(f"B: dense matrix, {k} x {n}")
    print(f"C: dense matrix, {m} x {n}")

    # Deterministic dense operands, matching the reference host exactly.
    b = np.ones((k, n), dtype=np.float32)
    mm, nn = np.meshgrid(np.arange(m), np.arange(n), indexing="ij")
    c = ((mm + 1.0) * (nn + 1.0) / m / n).astype(np.float32)

    cfg_kwargs = {}
    for name in ("tile_m", "window_k", "block_k", "group_blocks"):
        v = getattr(args, name)
        if v is not None:
            cfg_kwargs[name] = v
    cfg = SpmmConfig(**cfg_kwargs)
    from sextans_tpu.ops.engines import ENGINES

    fmt = next(
        (f for f, engines in ENGINES.items() if args.backend in engines),
        "vpu",
    )
    if args.autotune:
        from sextans_tpu.utils.autotune import (
            choose_backend,
            choose_config,
            choose_config_edge,
            choose_config_ell,
            choose_config_mxu,
        )

        if args.backend == "auto":  # joint choice across all formats
            picks = choose_backend(coo, n=n, base=cfg)
        else:
            picks = {
                "vpu": choose_config,
                "mxu": choose_config_mxu,
                "edge": choose_config_edge,
                "ell": choose_config_ell,
            }[fmt](coo, base=cfg, n=n)
        best = picks[0]
        cfg, fmt = best.config, best.fmt
        print(
            f"autotune: fmt={fmt} block_k={cfg.block_k} tile_m={cfg.tile_m} "
            f"group_blocks={cfg.group_blocks}"
        )
    if args.precise:
        cfg = cfg.with_(precise=True)

    split = None
    if args.hybrid:
        from sextans_tpu.ops.hybrid import split_structure

        split = split_structure(coo, n=n)
        print(split.summary())

    print("Packing sparse A ...", flush=True)
    t0 = time.perf_counter()
    if fmt == "mxu":
        from sextans_tpu.format.pack_mxu import pack_mxu

        packed = pack_mxu(coo, cfg, reorder_cols=args.reorder_cols,
                          reorder_rows_=args.reorder_rows)
    elif fmt == "edge":
        from sextans_tpu.format.pack_edge import pack_edge

        packed = pack_edge(coo, cfg, reorder_cols=args.reorder_cols,
                           reorder_rows_=args.reorder_rows)
    elif fmt == "ell":
        from sextans_tpu.format.pack_ell import pack_ell

        if args.reorder_cols or args.reorder_rows:
            raise SystemExit(
                "--reorder-cols/--reorder-rows have no effect on the ELL "
                "gather format (permutation-invariant); drop the flag"
            )
        packed = pack_ell(coo, cfg)
    else:
        packed = pack(coo, cfg, reorder_cols=args.reorder_cols,
                      reorder_rows_=args.reorder_rows)
    t_pack = time.perf_counter() - t0
    s = packed.stats
    print(
        f"done ({t_pack * 1e3:.1f} msec): {s.blocks} blocks, "
        f"fill {s.block_fill:.3f}, {s.groups} groups, group fill {s.group_fill:.3f}"
    )
    if args.save_packed:
        packed.save(args.save_packed)
        print(f"packed A saved to {args.save_packed}")

    c_ref = None
    if not args.skip_cpu:
        print("Run spmm on cpu...", flush=True)
        csr = CSRMatrix.from_coo(coo)
        t0 = time.perf_counter()
        c_ref = golden_spmm(csr, b, args.alpha, args.beta, c)
        t_cpu = time.perf_counter() - t0
        print(f"done ({t_cpu * 1e3:.3f} msec)")
        print(f"CPU GFLOPS: {gflops(nnz, m, n, t_cpu):.3f}")

    print("launch kernel", flush=True)
    import jax
    from sextans_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from sextans_tpu.ops.spmm import plan as make_plan
    from sextans_tpu.utils.timing import time_repeat

    if args.shards is not None and split is not None:
        # Row-sharded hybrid: the structure split runs on the mesh with
        # the same single-datapath property as the reference
        # (src/sextans.cpp:886-983) — parallel/hybrid_sharded.py.
        from sextans_tpu.parallel.hybrid_sharded import ShardedHybridPlan
        from sextans_tpu.parallel.sharding import make_mesh as _mk

        if args.shard_mode == "k":
            print("--hybrid shards row-wise; ignoring --shard-mode k")
        if len(jax.devices()) < args.shards:
            print(f"need {args.shards} devices, have {len(jax.devices())}")
            return 2
        mesh = _mk(args.shards)
        t0 = time.perf_counter()
        pl = ShardedHybridPlan(split, n, mesh=mesh)
        print(
            f"sharded hybrid pack "
            f"({(time.perf_counter() - t0) * 1e3:.1f} msec): "
            f"{args.shards} shards (row-mode, "
            f"residue fmt={pl.residue_fmt}), "
            f"m_local={pl.sharded_residue.m_local}"
        )
        print(f"mesh: {mesh}")
    elif args.shards is not None:
        # Multi-device path: pack per shard and execute under shard_map
        # over the device mesh (SURVEY.md §2.4 "multi-device").
        from sextans_tpu.parallel.partition import pack_sharded, pack_sharded_k
        from sextans_tpu.parallel.sharding import (
            ShardedSpmmPlan,
            ShardedSpmmPlanK,
            make_mesh,
        )

        if len(jax.devices()) < args.shards:
            print(f"need {args.shards} devices, have {len(jax.devices())}")
            return 2
        mesh = make_mesh(args.shards)
        t0 = time.perf_counter()
        if args.shard_mode == "k":
            sharded = pack_sharded_k(coo, args.shards, cfg, fmt=fmt)
            pl = ShardedSpmmPlanK(sharded, n, mesh=mesh)
        else:
            sharded = pack_sharded(
                coo, args.shards, cfg, fmt=fmt, balance=args.shard_balance
            )
            pl = ShardedSpmmPlan(sharded, n, mesh=mesh)
        print(
            f"sharded pack ({(time.perf_counter() - t0) * 1e3:.1f} msec): "
            f"{args.shards} shards ({args.shard_mode}-mode, fmt={fmt}), "
            f"m_local={sharded.m_local}, groups/shard={sharded.n_groups}"
        )
        if sharded.shard_nnz is not None:
            per = ", ".join(str(int(x)) for x in sharded.shard_nnz)
            print(
                f"per-shard nnz: [{per}]  "
                f"imbalance {sharded.nnz_imbalance:.2f}x"
            )
        print(f"mesh: {mesh}")
    elif split is not None:
        from sextans_tpu.ops.hybrid import HybridSpmmPlan

        pl = HybridSpmmPlan(split, n)
    else:
        pl = make_plan(packed, n, backend=args.backend)
    b_dev = jax.numpy.asarray(b)  # upload once; host->device link dominates otherwise
    c0 = jax.numpy.asarray(c)
    # in-device rp_time repeat loop (the reference's P_N bits 31:16 semantics)
    t_kernel = time_repeat(pl, b_dev, args.alpha, args.beta, c0, times=args.rp_time)
    print(f"Kernel time is {t_kernel * 1e3:f} ms")
    print(f"GFLOPS:{gflops(nnz, m, n, t_kernel):f}")

    if c_ref is not None:
        got = np.asarray(pl(b_dev, args.alpha, args.beta, c0))
        result = verify(c_ref, got)
        print(result)
        return 0 if result.passed else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
