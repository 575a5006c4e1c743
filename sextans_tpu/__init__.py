"""sextans_tpu — general-purpose SpMM in JAX: C = alpha * A @ B + beta * C.

A from-scratch JAX framework, run on NVIDIA GPUs, with the capabilities of
the Sextans FPGA accelerator (FPGA'22): arbitrary Matrix Market /
SuiteSparse sparse A, dense float32 B and C, compiled engines serving any
problem size at runtime (ops/engines.py picks the engine).

Quick start::

    import sextans_tpu as sx

    a = sx.read_mtx("matrix.mtx")            # COO, symmetric-expanded
    packed = sx.pack(a)                      # host pack pass (do once)
    c = sx.spmm(packed, b, alpha=0.85, beta=-2.06, c=c0)

See SURVEY.md for the reference layer map this framework re-implements.
"""

from sextans_tpu.format.coo import COOMatrix
from sextans_tpu.format.csr import CSCMatrix, CSRMatrix
from sextans_tpu.format.pack import (
    PackedSpMatrix,
    PackStats,
    pack,
    reorder_columns,
    reorder_rows,
)
from sextans_tpu.format.pack_cache import PackCache
from sextans_tpu.format.slots import slot_map
from sextans_tpu.format.pack_edge import PackedSpMatrixEdge, pack_edge
from sextans_tpu.format.pack_ell import PackedSpMatrixELL, pack_ell
from sextans_tpu.format.pack_mxu import PackedSpMatrixMXU, pack_mxu
from sextans_tpu.io.mtx import MtxHeader, read_mtx, read_mtx_coo, write_mtx
from sextans_tpu.ops.golden import golden_spmm, golden_spmm_exact, spmm_flops
from sextans_tpu.ops.autodiff import spmm_op, spmm_value_op
from sextans_tpu.ops.hybrid import HybridSpmmPlan, HybridSplit, split_structure
from sextans_tpu.ops.plan import SpmmPlan
from sextans_tpu.ops.serve import ServePlan, SpmmServer, bucketize_pack
from sextans_tpu.parallel.hybrid_sharded import ShardedHybridPlan
from sextans_tpu.parallel.partition import ShardedSpMatrix, pack_sharded, pack_sharded_k
from sextans_tpu.parallel.sharding import (
    ShardedSpmmPlan,
    ShardedSpmmPlanK,
    make_mesh,
    spmm_sharded,
    spmm_sharded_k,
)
from sextans_tpu.ops.spmm import plan, prepare, spmm
from sextans_tpu.utils.config import SpmmConfig
from sextans_tpu.utils.verify import VerifyResult, gflops, verify

__version__ = "0.1.0"

__all__ = [
    "COOMatrix",
    "CSRMatrix",
    "CSCMatrix",
    "PackedSpMatrix",
    "PackStats",
    "MtxHeader",
    "SpmmConfig",
    "VerifyResult",
    "read_mtx",
    "read_mtx_coo",
    "write_mtx",
    "pack",
    "PackCache",
    "reorder_columns",
    "reorder_rows",
    "slot_map",
    "pack_mxu",
    "pack_edge",
    "pack_ell",
    "PackedSpMatrixEdge",
    "PackedSpMatrixELL",
    "PackedSpMatrixMXU",
    "prepare",
    "plan",
    "SpmmPlan",
    "SpmmServer",
    "ServePlan",
    "bucketize_pack",
    "ShardedHybridPlan",
    "HybridSpmmPlan",
    "HybridSplit",
    "split_structure",
    "spmm",
    "spmm_op",
    "spmm_value_op",
    "ShardedSpMatrix",
    "pack_sharded",
    "pack_sharded_k",
    "ShardedSpmmPlan",
    "ShardedSpmmPlanK",
    "make_mesh",
    "spmm_sharded",
    "spmm_sharded_k",
    "golden_spmm",
    "golden_spmm_exact",
    "spmm_flops",
    "verify",
    "gflops",
]
