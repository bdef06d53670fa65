"""Tile choice for the port's NT GEMM kernels (csrc/gemm_mainloop.cuh), in
the role of deepgemm_tpu/heuristics/configs.py:get_gemm_config.

The kernel's block is 64 rows by ``block_n`` columns, 128 bytes of k per
stage, 4 stages. Two widths are built: 128 (the default, half the shared
memory traffic per output) and 64, taken when the 128-wide grid would leave
SMs idle (fewer blocks than two waves of SMs can hold)."""

import dataclasses

from ..utils.math import ceil_div
from .arch import H100_SXM

BLOCK_M = 64
BLOCK_K_BYTES = 128
STAGES = 4
BLOCK_N_CHOICES = (128, 64)


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    block_m: int
    block_n: int

    @property
    def smem_bytes(self) -> int:
        return STAGES * (self.block_m + self.block_n) * (BLOCK_K_BYTES + 16)


def get_gemm_config(m: int, n: int, num_groups: int = 1,
                    num_sms: int = H100_SXM.num_sms) -> GemmConfig:
    """``m`` is the row count of one group (max_m for the masked kernel)."""
    blocks_at = {bn: ceil_div(m, BLOCK_M) * ceil_div(n, bn) * num_groups
                 for bn in BLOCK_N_CHOICES}
    block_n = 128 if blocks_at[128] >= 2 * num_sms else 64
    cfg = GemmConfig(block_m=BLOCK_M, block_n=block_n)
    assert cfg.smem_bytes <= H100_SXM.smem_per_block
    return cfg
