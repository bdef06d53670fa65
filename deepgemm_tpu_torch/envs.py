"""Environment variables read by the PyTorch/CUDA port.

| Variable | Meaning |
|---|---|
| ``DGT_NVCC``      | path of the CUDA compiler (default ``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on ``PATH``) |
| ``DGT_BUILD_DIR`` | where the kernels' shared libraries are built (default ``deepgemm_tpu_torch/_build``) |
| ``DGT_SPARSE_GATHER`` | how the decode's attention gets its selected cache rows: ``flat`` (the default) gathers them first, ``pallas`` reads them in place in the gather-fused attention kernel (JAX's names); any other value raises |
| ``DGT_MEGA_ACT_FP8`` | the mega block's act between L1 and L2: ``1`` fp8 (requantized per 128), ``0`` or unset bf16 |
| ``DGT_SCALE_STRATEGY`` | pins the dense FP8 GEMM's scale step: ``promote`` (exact f32 promotion per 128-deep block) or ``dequant`` (scales folded into bf16 operands, one full-depth sum); unset: ``dequant`` where both operands' scales are powers of two by type (packed UE8M0 int32, or folded FP4), else ``promote`` (JAX's rule) |
| ``DGT_MK_ALIGNMENT`` | the row (m-grouped) or k (k-grouped) alignment of each group's start in the psum layouts, default 128; read once, when the runtime knobs are first used |
| ``DGT_MEGA_POOL`` | pins the wave pool of the general (several-rank) fused mega kernel: the slabs that wait and compute together (a divisor of the rank count); unset: ``pick_wave_pool``'s rule |
| ``DGT_GROUPED_DUAL_B`` | ``1`` runs the contiguous grouped GEMM in its dual-B form (256-row tiles, a second B on a tile whose halves belong to two groups) where the shapes allow; unset or any other value: the 64-row form (JAX's default) |

All are read lazily, never at import: each at its use, ``DGT_MK_ALIGNMENT``
and ``DGT_SCALE_STRATEGY`` when the runtime knobs are first read.
"""

import os
from typing import Optional


def nvcc() -> Optional[str]:
    return os.environ.get('DGT_NVCC')


def build_dir() -> Optional[str]:
    return os.environ.get('DGT_BUILD_DIR')


def sparse_gather() -> str:
    """``DGT_SPARSE_GATHER``: 'flat' (the default) or 'pallas'; the indexer
    raises for any other value."""
    return os.environ.get('DGT_SPARSE_GATHER', 'flat')


def mega_act_fp8() -> Optional[str]:
    """``DGT_MEGA_ACT_FP8``: '1' requantizes the mega block's act to fp8
    between L1 and L2, '0' keeps it bf16 (the default when unset)."""
    return os.environ.get('DGT_MEGA_ACT_FP8')


def grouped_dual_b() -> bool:
    """``DGT_GROUPED_DUAL_B=1`` pins the contiguous kernel's dual-B form."""
    return os.environ.get('DGT_GROUPED_DUAL_B') == '1'


def scale_strategy() -> Optional[str]:
    """``DGT_SCALE_STRATEGY``: 'promote', 'dequant' or None (the rule)."""
    return os.environ.get('DGT_SCALE_STRATEGY')


def mk_alignment() -> int:
    """``DGT_MK_ALIGNMENT``: the psum layouts' group alignment (128)."""
    return int(os.environ.get('DGT_MK_ALIGNMENT', 128))


def mega_pool() -> Optional[str]:
    """``DGT_MEGA_POOL``: the general fused mega kernel's wave pool, or None."""
    return os.environ.get('DGT_MEGA_POOL')

