"""Device resolution and runtime knobs.

Entry points take an explicit ``device``. ``None`` means the CUDA card; when
there is none they raise instead of running on the CPU. The CPU runs only
when the caller asks for it (``device='cpu'``), as the CPU tests do.
"""

from typing import Optional, Union

import torch

_num_sms_override: Optional[int] = None


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
