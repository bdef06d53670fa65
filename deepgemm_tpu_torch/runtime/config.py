"""Device resolution and runtime knobs (counterpart of
deepgemm_tpu/runtime/config.py).

Entry points take an explicit ``device``. ``None`` means the CUDA card; when
there is none they raise instead of running on the CPU. The CPU runs only
when the caller asks for it (``device='cpu'``), as the CPU tests do.

The knobs are process-wide, as in JAX: :func:`runtime` holds them, made at
first use from ``DGT_MK_ALIGNMENT`` and ``DGT_SCALE_STRATEGY``. The psum
layouts of the contiguous and k-grouped GEMMs read the mk alignment; the
dense GEMM reads the forced scale strategy. The tensor-core utilisation,
programmatic dependent launch, compile-dims and block-size-multiple knobs
change nothing on the card: they are accepted and stored, as JAX stores
them.
"""

import dataclasses
import functools
from typing import Optional, Union

import torch

from .. import envs

_num_sms_override: Optional[int] = None
SCALE_STRATEGIES = ('promote', 'dequant')


@dataclasses.dataclass
class Runtime:
    mk_alignment: int
    force_scale_strategy: Optional[str]
    block_m_multiple_of: int = 1
    block_n_multiple_of: int = 1
    ignore_compile_dims: bool = False
    tc_util: int = 100
    pdl: bool = False


@functools.lru_cache(maxsize=None)
def runtime() -> Runtime:
    """The process's knobs, made at first use from the environment."""
    strategy = envs.scale_strategy()
    if strategy is not None and strategy not in SCALE_STRATEGIES:
        raise ValueError(f'DGT_SCALE_STRATEGY={strategy!r}: expected one of {SCALE_STRATEGIES}')
    return Runtime(mk_alignment=envs.mk_alignment(), force_scale_strategy=strategy)


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``None`` -> ``cuda``. A CUDA device without a card raises."""
    dev = torch.device('cuda' if device is None else device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the plain '
            'PyTorch path on the CPU')
    return dev


def set_num_sms(num: int):
    """Cap the SM count the tile chooser plans for (analog of
    ``deep_gemm.set_num_sms``)."""
    global _num_sms_override
    _num_sms_override = int(num)


def get_num_sms(device: Union[str, torch.device, None] = None) -> int:
    """The cap set with :func:`set_num_sms`, else the card's SM count."""
    if _num_sms_override is not None:
        return _num_sms_override
    dev = resolve_device(device)
    if dev.type != 'cuda':
        raise RuntimeError('the SM count is a property of a CUDA device')
    return torch.cuda.get_device_properties(dev).multi_processor_count


def set_tc_util(percent: int):
    """Stored only: the kernels do not throttle their tensor cores."""
    runtime().tc_util = int(percent)


def get_tc_util() -> int:
    return runtime().tc_util


def set_pdl(enable: bool):
    """Stored only: no kernel launches with programmatic dependent launch."""
    runtime().pdl = bool(enable)


def get_pdl() -> bool:
    return runtime().pdl


def set_ignore_compile_dims(value: bool):
    """Stored only: the kernels take every dim at run time."""
    runtime().ignore_compile_dims = bool(value)


def set_block_size_multiple_of(block_m: int, block_n: int):
    """Stored only: the tile chooser's widths are fixed (heuristics/configs.py)."""
    runtime().block_m_multiple_of = int(block_m)
    runtime().block_n_multiple_of = int(block_n)


def set_mk_alignment_for_contiguous_layout(alignment: int):
    """The psum layouts' group alignment: each group starts at the previous
    group's end aligned up to it (rows for the m-grouped GEMMs, k for the
    k-grouped). The contiguous kernel's tiles are 128 rows where it is a
    multiple of 128, else 64 rows, which need a multiple of 64."""
    runtime().mk_alignment = int(alignment)


def get_mk_alignment_for_contiguous_layout() -> int:
    return runtime().mk_alignment
