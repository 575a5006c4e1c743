"""Typed configuration for the SpMM pipeline.

The reference hard-codes its architecture knobs as compile-time constants
(NUM_CH_SPARSE / WINDOW_SIZE / DEP_DIST_LOAD_STORE / URAM_DEPTH,
src/sextans.h:7-15). Here they become a runtime dataclass the autotuner can
sweep (SURVEY.md §5 "Config / flag system").
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

__all__ = ["SpmmConfig", "cdiv", "round_up"]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclass(frozen=True)
class SpmmConfig:
    """Tiling configuration for pack + engine.

    Mapping of the reference's architecture constants:

    * ``tile_m``   — rows per M-tile of the block formats (blocks of one
      group share an M-tile); for the ELL format, the row count is rounded
      up to a multiple of it. The analog of the 64-PE x URAM accumulator
      partition (src/sextans.h:15).
    * ``window_k`` — columns of A (= rows of B) per K-window; the analog of
      WINDOW_SIZE=4096 (src/sextans.h:11).
    * ``block_k``  — block width: A is packed into dense 8 x block_k
      sub-blocks. Replaces the reference's per-nonzero 64-bit edge encoding
      (src/sparse_helper.h:406-473) with a dense micro-tile.
    * ``group_blocks`` — blocks per group, the packing unit of one
      (M-tile, K-window) job; analog of the FIFO batch granularity.
    * ``interleave`` — round-robin blocks across row-stripes inside a tile
      (the spiritual successor of the out-of-order RAW scheduler,
      src/sparse_helper.h:292-342); it changes the packed order, never the
      result.
    """

    tile_m: int = 512
    window_k: int = 2048
    block_k: int = 8
    group_blocks: int = 256
    interleave: bool = True
    # precise — float64 accumulation in the engines, one rounding to
    # float32 in the alpha/beta epilogue (docs/ACCURACY.md). 0/False = fast
    # path; 1 and 2 are both accepted (2 was a deeper compensation level of
    # the earlier kernels and now behaves like 1).
    precise: int = 0
    # edge_chunk — edges per chunk of the edge format (format/pack_edge.py),
    # the structure-independent path: one record per nonzero like the
    # reference PEG's edge stream (src/sextans.cpp:388-419).
    edge_chunk: int = 2048
    # ell_r — slots per row of the ELL gather format (format/pack_ell.py);
    # None → cost-based choice from the degree histogram at pack time
    # (choose_slots_per_row).
    ell_r: Optional[int] = None

    def __post_init__(self):
        if self.tile_m % 8 != 0 or self.tile_m <= 0:
            raise ValueError("tile_m must be a positive multiple of 8")
        if self.block_k not in (1, 2, 4, 8, 16, 32, 64, 128):
            raise ValueError("block_k must be a power of two <= 128")
        if self.window_k % self.block_k != 0:
            raise ValueError("window_k must be a multiple of block_k")
        if self.window_k % 8 != 0:
            raise ValueError("window_k must be a multiple of 8")
        if self.group_blocks <= 0:
            raise ValueError("group_blocks must be positive")
        if int(self.precise) not in (0, 1, 2):
            raise ValueError("precise must be 0/False, 1/True, or 2")
        if self.edge_chunk <= 0 or self.edge_chunk % 8 != 0:
            raise ValueError("edge_chunk must be a positive multiple of 8")
        if self.ell_r is not None and self.ell_r < 1:
            raise ValueError("ell_r must be >= 1")

    def validate_vpu(self) -> None:
        """Extra constraint of the block format (format/pack.py): a group's
        vals row holds whole chunks of 128//block_k blocks (the native and
        NumPy packers lay groups out in these chunks)."""
        chunk = max(1, 128 // self.block_k)
        if self.group_blocks % chunk != 0:
            raise ValueError(
                f"group_blocks must be a multiple of {chunk} (=128/block_k) "
                "for the VPU block format"
            )

    @property
    def stripes_per_tile(self) -> int:
        return self.tile_m // 8

    def with_(self, **kw) -> "SpmmConfig":
        return replace(self, **kw)
