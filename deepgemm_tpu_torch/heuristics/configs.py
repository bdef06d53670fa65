"""Tile choice for the port's NT GEMM kernels (csrc/gemm_mainloop.cuh), in
the role of deepgemm_tpu/heuristics/configs.py:get_gemm_config.

The kernel's block is 64 rows by ``block_n`` columns, 128 bytes of k per
stage, 4 stages. Two widths are built: 128 (the default, half the shared
memory traffic per output) and 64, taken when the 128-wide grid would leave
SMs idle (fewer blocks than two waves of SMs can hold). Every layout uses
the same rule on its own grid: the dense and masked kernels one problem per
group, the contiguous kernel the concatenated rows of all groups, the
k-grouped kernel one [m, n] output per group.

The contiguous kernel's dual-B form (``DUAL_B_CONFIG``) takes 256-row
tiles with a second B slab a stage; its width is fixed by shared memory."""

import dataclasses

from ..utils.math import ceil_div
from .arch import H100_SXM

BLOCK_M = 64
BLOCK_K_BYTES = 128
STAGES = 4
BLOCK_N_CHOICES = (128, 64)
# Row alignment of each group in the contiguous layout, and k alignment of
# each group in the psum k-grouped layout (the JAX package's default
# DGT_MK_ALIGNMENT, deepgemm_tpu/runtime/config.py:38).
MK_ALIGNMENT = 128


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    block_m: int
    block_n: int
    b_slabs: int = 1        # B tiles a stage holds: 2 in the dual-B form

    @property
    def smem_bytes(self) -> int:
        return STAGES * (self.block_m + self.b_slabs * self.block_n) * (BLOCK_K_BYTES + 16)


def get_gemm_config(m: int, n: int, num_groups: int = 1,
                    num_sms: int = H100_SXM.num_sms) -> GemmConfig:
    """``m`` is the row count of one problem and ``num_groups`` the number
    of problems in the grid: max_m and G for the masked kernel, the total
    row count and 1 for the contiguous kernel, m and G for the k-grouped
    kernel."""
    blocks_at = {bn: ceil_div(m, BLOCK_M) * ceil_div(n, bn) * num_groups
                 for bn in BLOCK_N_CHOICES}
    block_n = 128 if blocks_at[128] >= 2 * num_sms else 64
    cfg = GemmConfig(block_m=BLOCK_M, block_n=block_n)
    assert cfg.smem_bytes <= H100_SXM.smem_per_block
    return cfg


# The dual-B tile, fixed: 256 rows by 64 columns with a second B slab, 4
# stages of (256 + 2 x 64) rows of 144 bytes, 221184 bytes of shared memory;
# 128 columns would take 294912, above a block's 232448 (csrc/contiguous.cu
# asserts it at compile time). The JAX package picks its tile against the
# TPU's VMEM (deepgemm_tpu/heuristics/configs.py:get_dual_b_config).
DUAL_B_CONFIG = GemmConfig(block_m=4 * BLOCK_M, block_n=64, b_slabs=2)
