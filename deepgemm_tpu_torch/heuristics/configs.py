"""Tile choice for the port's GEMM kernels, in the role of
deepgemm_tpu/heuristics/configs.py:get_gemm_config: :func:`get_sm90_config`
for the Hopper mainloop (csrc/gemm_sm90.cuh: every dense form, the FP8
k-grouped kernel, every form of the contiguous grouped kernel, the masked
kernel and the fused dispatch + L1), :func:`get_gemm_config` for the
mma.sync mainloop (csrc/gemm_mainloop.cuh: the bf16 k-grouped kernel).

The mma.sync mainloop:

The kernel's block is 64 rows by ``block_n`` columns, 64 bf16 elements of k
a stage, 4 stages. Two widths are built: 128 (the default, half the shared
memory traffic per output) and 64, taken when the 128-wide grid would leave
SMs idle (fewer blocks than two waves of SMs can hold), one [m, n] output a
group.

:func:`smem_bytes` is the shared memory of an instance as
csrc/gemm_mainloop.cuh plans it (``SmemPlan``)."""

import dataclasses
import functools
from typing import Optional, Tuple

from ..utils.math import ceil_div
from .arch import H100_SXM

BLOCK_M = 64
BLOCK_K_BYTES = 128
STAGES = 4
BLOCK_N_CHOICES = (128, 64)


def smem_bytes(block_m: int, block_n: int) -> int:
    """Shared memory of one kernel instance: STAGES stages of 128-byte k
    rows of A and B, each padded by 16 bytes."""
    return STAGES * (block_m + block_n) * (BLOCK_K_BYTES + 16)


@dataclasses.dataclass(frozen=True)
class GemmConfig:
    block_m: int
    block_n: int

    @property
    def smem_bytes(self) -> int:
        """The shared memory of the e4m3 (or bf16) NT instance at this tile."""
        return smem_bytes(self.block_m, self.block_n)


def get_gemm_config(m: int, n: int, num_groups: int = 1,
                    num_sms: int = H100_SXM.num_sms) -> GemmConfig:
    """``m`` is the row count of one problem and ``num_groups`` the number
    of problems in the grid: m and G for the bf16 k-grouped kernel."""
    blocks_at = {bn: ceil_div(m, BLOCK_M) * ceil_div(n, bn) * num_groups
                 for bn in BLOCK_N_CHOICES}
    block_n = 128 if blocks_at[128] >= 2 * num_sms else 64
    return GemmConfig(block_m=BLOCK_M, block_n=block_n)


# The Hopper mainloop (csrc/gemm_sm90.cuh). A tile is block_m rows (64 or
# 128: one or two consumer warpgroups of 64 rows) by SM90_BLOCK_N columns;
# a stage holds 128 bytes of k of A and B (128-byte swizzled) and, for e4m3,
# their scales; the epilogue stages each warpgroup's 64 rows in a swizzled
# shared tile for its TMA stores. The contiguous kernel's e4m3 NN form adds
# two k-major B tiles (the transposed stages); its dual-B form is a 256 x 64
# tile (two warpgroups of 128 rows) with room for two B tiles a stage. (The
# kernel asserts at compile time that a consumer thread's f32 register sets
# fit its setmaxnreg budget.) The masked kernel and the fused dispatch + L1
# take 64-row tiles where a group's rows fit them, else 128.
SM90_BLOCK_N = 128
SM90_BLOCK_K = 128
SM90_MAX_STAGES = 8
# The contiguous kernel's ring: 4 stages ran faster than the 5-6 that fit on
# the H100 at the training step's shapes (chip_smoke.py --variants), so no
# more are taken.
CONTIGUOUS_MAX_STAGES = 4
# The masked kernel's and the fused dispatch + L1's ring: at 3 stages the
# fused dispatch + L1 in bf16 at 8 ranks of one card ran ~2x faster than at
# the 6 that fit, and the decode's calls within ~5% of their best ring, on
# an earlier e4m3-wgmma body with the same 32 KB stages
# (chip_smoke.py --masked-variants times each cap).
MASKED_MAX_STAGES = 3
DUAL_BLOCK_M, DUAL_BLOCK_N = 256, 64
CONTIGUOUS_FORMS = ('nt', 'nn', 'dual')


@dataclasses.dataclass(frozen=True)
class Sm90Config:
    block_m: int
    block_n: int
    num_stages: int
    num_sms: int            # the persistent grid: min(tiles, SMs)
    smem_bytes: int


def sm90_smem_bytes(block_m: int, num_stages: int, out_bytes: int, table_groups: int = 0,
                    block_n: int = SM90_BLOCK_N, b_tiles: int = 1, scaled: bool = True,
                    transposed_b: bool = False) -> int:
    """Shared memory of a Hopper-mainloop instance as csrc/gemm_sm90.cuh
    (``Plan``) lays it out: 1024 bytes of alignment slack, the epilogue's
    staging tile (64 rows of block_n outputs per warpgroup of 64, or of 128
    rows in the dual-B tile), two k-major B tiles where an e4m3 B is
    transposed, per stage A and ``b_tiles`` B tiles (128 bytes a row), their
    scales where ``scaled`` (4 bytes a row of A and a column of B) and two
    8-byte barriers, and for the k-grouped kernel a table of 8 bytes a
    group."""
    warpgroups = block_m // (128 if b_tiles == 2 else 64)
    staging = warpgroups * 64 * block_n * out_bytes
    transposed = 2 * block_n * SM90_BLOCK_K if transposed_b else 0
    scales = (block_m + b_tiles * block_n) * 4 if scaled else 0
    stage = block_m * SM90_BLOCK_K + b_tiles * block_n * SM90_BLOCK_K + scales + 16
    return 1024 + staging + transposed + num_stages * stage + 8 * table_groups


def contiguous_block_m(mk_alignment: int) -> int:
    """The contiguous kernel's rows a tile: 128 (each expert's weights
    stream once for 128 rows) where the mk alignment is a multiple of 128,
    else 64; no tile then straddles two groups."""
    return 128 if mk_alignment % 128 == 0 else 64


def widen_smem_bytes(block_m: int, num_stages: int, out_bytes: int, elem_a: int,
                     elem_b: int, block_n: int = SM90_BLOCK_N) -> int:
    """Shared memory of a widening instance of the Hopper mainloop (the
    dense forms on bf16 products, csrc/gemm_sm90.cuh ``WidenPlan``), operands
    of ``elem_a`` / ``elem_b`` bytes (1 e4m3, 2 bf16): 1024 bytes of slack,
    the epilogue's staging tiles, two widened bf16 tiles of B where B is
    e4m3, then per stage 128 values of k of A and B (one 128-byte box a row
    for e4m3, two for bf16; two bf16 operands, the masked kernel's bf16
    form: 64 values, one box), the e4m3 sides' scales and two barriers."""
    staging = block_m * block_n * out_bytes
    widened = 2 * 2 * block_n * SM90_BLOCK_K if elem_b == 1 else 0
    scales = (block_m if elem_a == 1 else 0) + (block_n if elem_b == 1 else 0)
    box = 1 if elem_a == elem_b == 2 else 0     # two bf16 operands: one box a row
    stage = ((elem_a - box) * block_m + (elem_b - box) * block_n) * SM90_BLOCK_K \
        + 4 * scales + 16
    return 1024 + staging + widened + num_stages * stage


@functools.lru_cache(maxsize=1024)
def get_sm90_config(m: int, n: int, num_groups: int = 1, out_bytes: int = 2,
                    num_sms: int = H100_SXM.num_sms, k_grouped: bool = False,
                    contiguous: Optional[str] = None, elem: int = 1,
                    mk_alignment: int = 128,
                    widen: Optional[Tuple[int, int]] = None,
                    masked: bool = False, max_stages: Optional[int] = None) -> Sm90Config:
    """The Hopper mainloop's tile for ``num_groups`` problems of [m, n]
    (dense: 1; k-grouped: G, with its per-group table) with an output of
    ``out_bytes`` (2 bf16, 4 f32): 128 rows (two consumer warpgroups)
    unless m fits 64 rows or the 128-row tiles would leave SMs idle.

    ``contiguous`` ('nt', 'nn' or 'dual') is the contiguous grouped kernel
    over the m rows of all ``num_groups`` groups, operands of ``elem`` bytes
    (1 e4m3, 2 bf16): :func:`contiguous_block_m` rows for the mk alignment
    ('dual': the 256 x 64 tile), one work item a tile whatever the group.
    ``widen`` (elem_a, elem_b) is the dense widening kernel
    (:func:`widen_smem_bytes`), whose 64-row tiles are 64 columns wide where
    128-wide ones would leave SMs idle; ``elem`` 2 alone the dense bf16 x
    bf16 form. ``masked`` is the masked kernel (and the fused dispatch + L1)
    over ``num_groups`` groups of m rows, operands of ``elem`` bytes: 64
    rows where m <= 64 (one consumer warpgroup: the decode's 40 live rows),
    else 128.

    As many stages as the shared memory left beside the fixed parts holds,
    at most ``max_stages``, by default SM90_MAX_STAGES (contiguous:
    CONTIGUOUS_MAX_STAGES; masked: MASKED_MAX_STAGES); one block per SM, at
    most one per tile."""
    if contiguous is not None and contiguous not in CONTIGUOUS_FORMS:
        raise ValueError(f'contiguous form {contiguous!r}: one of {CONTIGUOUS_FORMS}')
    block_n, b_tiles = SM90_BLOCK_N, 1
    if contiguous == 'dual':
        block_m, block_n, b_tiles = DUAL_BLOCK_M, DUAL_BLOCK_N, 2
    elif contiguous is not None:
        block_m = contiguous_block_m(mk_alignment)
    items = lambda bm: ceil_div(m, bm) * ceil_div(n, block_n) * (
        1 if contiguous else num_groups)
    if masked:
        block_m = 64 if m <= 64 else 128
    elif contiguous is None:
        block_m = 64 if m <= 64 or items(128) < num_sms else 128
    if widen and block_m == 64 and items(64) < num_sms:
        block_n = 64
    table = num_groups if k_grouped else 0
    if masked:
        widen = (elem, elem)
    smem = lambda stages: (
        widen_smem_bytes(block_m, stages, out_bytes, *widen, block_n) if widen else
        sm90_smem_bytes(block_m, stages, out_bytes, table, block_n, b_tiles, scaled=elem == 1,
                        transposed_b=contiguous == 'nn' and elem == 1))
    smem_limit = H100_SXM.smem_per_block
    stages = max_stages or (MASKED_MAX_STAGES if masked else SM90_MAX_STAGES
                            if contiguous is None else CONTIGUOUS_MAX_STAGES)
    while stages > 2 and smem(stages) > smem_limit:
        stages -= 1
    if smem(stages) > smem_limit:
        raise ValueError(f'{num_groups} groups: the Hopper mainloop\'s shared memory '
                         f'({smem(stages)} bytes) exceeds a block\'s {smem_limit}')
    return Sm90Config(block_m=block_m, block_n=block_n, num_stages=stages,
                      num_sms=max(1, min(items(block_m), num_sms)), smem_bytes=smem(stages))
