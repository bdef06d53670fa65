"""Test helpers (counterpart of deepgemm_tpu/testing/utils.py):
``get_arch_major``, ``get_device_core_count`` and ``test_filter``, read from
the CUDA card."""

import functools
import os

import torch


def get_arch_major() -> int:
    """The CUDA card's SM major (9 on an H100), or 0 without a card."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.get_device_capability()[0]


def get_device_core_count() -> int:
    """The CUDA card's SM count, or 0 without a card."""
    if not torch.cuda.is_available():
        return 0
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


def test_filter(fn):
    """Run a test callable only when ``DGT_TEST_FILTER`` is unset or is part
    of the function's name; otherwise print that it was skipped and return
    None."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        flt = os.environ.get('DGT_TEST_FILTER')
        if flt and flt not in fn.__name__:
            print(f'Skipping {fn.__name__} (filtered)')
            return None
        return fn(*args, **kwargs)
    return wrapper

