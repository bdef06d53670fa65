"""Tile choice for the port's GEMM kernels (csrc/gemm_mainloop.cuh), in the
role of deepgemm_tpu/heuristics/configs.py:get_gemm_config.

The kernel's block is 64 rows by ``block_n`` columns, 128 k elements a stage
(64 for bf16 x bf16), 4 stages. Two widths are built: 128 (the default, half the shared
memory traffic per output) and 64, taken when the 128-wide grid would leave
SMs idle (fewer blocks than two waves of SMs can hold). Every layout uses
the same rule on its own grid: the dense and masked kernels one problem per
group, the contiguous kernel the concatenated rows of all groups, the
k-grouped kernel one [m, n] output per group.

The contiguous kernel's dual-B form (``DUAL_B_CONFIG``) takes 256-row
tiles with a second B slab a stage; its width is fixed by shared memory.

:func:`smem_bytes` is the shared memory of an instance as
csrc/gemm_mainloop.cuh plans it (``SmemPlan``); the wrappers check it
against a block's 227 KiB before they launch."""

import dataclasses

from ..utils.math import ceil_div
from .arch import H100_SXM

BLOCK_M = 64
BLOCK_K_BYTES = 128
STAGES = 4
BLOCK_N_CHOICES = (128, 64)


def smem_bytes(block_m: int, block_n: int, elem_a: int = 1, elem_b: int = 1,
               a_mn: bool = False, b_mn: bool = False, b_slabs: int = 1) -> int:
    """Shared memory of one kernel instance: ``elem_a`` / ``elem_b`` bytes
    per element (1 e4m3 or planar FP4, 2 bf16), ``a_mn`` / ``b_mn`` an
    MN-major operand (its stages raw, plus one transposed k-major stage).
    A stage holds 128 k elements, 64 for bf16 x bf16."""
    ke = 64 if elem_a == 2 and elem_b == 2 else 128
    pitch_a, pitch_b = ke * elem_a + 16, ke * elem_b + 16
    stage_a = ke * (block_m * elem_a + 16) if a_mn else block_m * pitch_a
    stage_b = ke * (block_n * elem_b + 16) if b_mn else block_n * pitch_b
    return (STAGES * (stage_a + b_slabs * stage_b) + (block_m * pitch_a if a_mn else 0)
            + (block_n * pitch_b if b_mn else 0))


def check_smem(nbytes: int, what: str):
    """Raise before a launch that a block's shared memory could not hold."""
    if nbytes > H100_SXM.smem_per_block:
        raise ValueError(f'{what}: {nbytes} bytes of shared memory, a block may use '
                         f'{H100_SXM.smem_per_block}')


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    block_m: int
    block_n: int
    b_slabs: int = 1        # B tiles a stage holds: 2 in the dual-B form

    @property
    def smem_bytes(self) -> int:
        """The shared memory of the e4m3 (or bf16) NT instance at this tile."""
        return smem_bytes(self.block_m, self.block_n, b_slabs=self.b_slabs)


def get_gemm_config(m: int, n: int, num_groups: int = 1,
                    num_sms: int = H100_SXM.num_sms) -> GemmConfig:
    """``m`` is the row count of one problem and ``num_groups`` the number
    of problems in the grid: max_m and G for the masked kernel, the total
    row count and 1 for the contiguous kernel, m and G for the k-grouped
    kernel."""
    blocks_at = {bn: ceil_div(m, BLOCK_M) * ceil_div(n, bn) * num_groups
                 for bn in BLOCK_N_CHOICES}
    block_n = 128 if blocks_at[128] >= 2 * num_sms else 64
    return GemmConfig(block_m=BLOCK_M, block_n=block_n)


# The dual-B tile, fixed: 256 rows by 64 columns with a second B slab, 4
# stages of (256 + 2 x 64) rows of 144 bytes, 221184 bytes of shared memory;
# 128 columns would take 294912, above a block's 232448 (csrc/contiguous.cu
# asserts it at compile time). The JAX package picks its tile against the
# TPU's VMEM (deepgemm_tpu/heuristics/configs.py:get_dual_b_config).
DUAL_B_CONFIG = GemmConfig(block_m=4 * BLOCK_M, block_n=64, b_slabs=2)
