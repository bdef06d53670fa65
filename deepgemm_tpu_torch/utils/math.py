"""Quantization utilities: the numerics contract of deepgemm_tpu/utils/math.py
in PyTorch, bit for bit.

  * FP8 is ``torch.float8_e4m3fn``. Values are clamped to +-448 before the
    cast, so overflow saturates whatever the cast itself does on a device.
  * Scale factors (SF) are float32. UE8M0 scales are f32 powers of two.
  * Every function runs on the device of its input.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # max finite magnitude of e4m3fn
FP8_AMAX_EPS = 1e-4
# f32 elements per chunk of a large elementwise pass (1 GiB of f32)
_CHUNK_ELEMS = 1 << 28


def ceil_div(x: int, y: int) -> int:
    return (x + y - 1) // y


def align(x: int, y: int) -> int:
    return ceil_div(x, y) * y


def ceil_to_ue8m0(x: torch.Tensor) -> torch.Tensor:
    """Round |x| up to the next power of two: bump the biased exponent when
    any mantissa bit is set, clamp the exponent to [1, 254]."""
    bits = x.abs().float().contiguous().view(torch.int32)
    exp = ((bits >> 23) & 0xFF) + ((bits & 0x7FFFFF) != 0).to(torch.int32)
    exp = exp.clamp(1, 254)
    return (exp << 23).view(torch.float32)


def pack_ue8m0_to_int(x: torch.Tensor) -> torch.Tensor:
    """Pack 4 UE8M0 (power-of-two f32) scales into one int32 along the last
    dim, little-endian (the first scale in the low byte)."""
    assert x.dtype == torch.float32 and x.shape[-1] % 4 == 0
    exp_u8 = (x.contiguous().view(torch.int32) >> 23).to(torch.uint8)
    return exp_u8.contiguous().view(torch.int32)


def unpack_ue8m0_from_int(packed_sf: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_ue8m0_to_int`."""
    assert packed_sf.dtype == torch.int32
    exp = packed_sf.contiguous().view(torch.uint8).to(torch.int32)
    return (exp << 23).view(torch.float32)


def cast_to_fp8(x: torch.Tensor) -> torch.Tensor:
    """Saturating f32/bf16 -> e4m3fn cast."""
    return x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn)


def _amax_sf(x_view: torch.Tensor, dims, use_ue8m0: bool) -> torch.Tensor:
    amax = x_view.abs().float().amax(dim=dims, keepdim=True).clamp(min=FP8_AMAX_EPS)
    sf = amax / FP8_MAX
    return ceil_to_ue8m0(sf) if use_ue8m0 else sf


def per_token_cast_to_fp8(x: torch.Tensor, use_ue8m0: bool, gran_k: int = 128,
                          use_packed_ue8m0: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1 x gran_k activation quantization: SF shape [m, ceil(n / gran_k)]."""
    assert x.dim() == 2
    m, n = x.shape
    padded_n = align(n, gran_k)
    x_view = F.pad(x, (0, padded_n - n)).reshape(m, padded_n // gran_k, gran_k)
    sf = _amax_sf(x_view, (2,), use_ue8m0)                   # [m, nsf, 1]
    x_fp8 = cast_to_fp8(x_view * (1.0 / sf)).reshape(m, padded_n)[:, :n]
    sf = sf.reshape(m, padded_n // gran_k)
    return x_fp8.contiguous(), pack_ue8m0_to_int(sf) if use_packed_ue8m0 else sf


def per_channel_cast_to_fp8(x: torch.Tensor, use_ue8m0: bool,
                            gran_k: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """gran_k x 1 quantization along rows: SF shape [m / gran_k, n]."""
    assert x.dim() == 2 and x.shape[0] % gran_k == 0
    m, n = x.shape
    x_view = x.reshape(-1, gran_k, n)
    sf = _amax_sf(x_view, (1,), use_ue8m0)                   # [m/g, 1, n]
    return (cast_to_fp8(x_view * (1.0 / sf)).reshape(m, n),
            sf.reshape(m // gran_k, n))


def per_block_cast_to_fp8(x: torch.Tensor, use_ue8m0: bool,
                          gran_k: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """gran_k x gran_k (weight) quantization: SF [..., ceil(m/g), ceil(n/g)].
    Leading dims are independent matrices, each cast exactly as alone."""
    assert x.dim() >= 2
    *lead, m, n = x.shape
    pm, pn = align(m, gran_k), align(n, gran_k)
    x_view = F.pad(x, (0, pn - n, 0, pm - m)).reshape(
        *lead, pm // gran_k, gran_k, pn // gran_k, gran_k)
    sf = _amax_sf(x_view, (-3, -1), use_ue8m0)
    x_scaled = cast_to_fp8(x_view * (1.0 / sf)).reshape(*lead, pm, pn)[..., :m, :n]
    return x_scaled.contiguous(), sf.reshape(*lead, pm // gran_k, pn // gran_k)


def per_custom_dims_cast_to_fp8(x: torch.Tensor, dims, use_ue8m0: bool
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One scale per index of the kept ``dims``, amax over all other dims
    (the indexer's per-token kv cast): returns the e4m3 tensor and the f32
    scales with every unit dim squeezed."""
    keep = set(dims)
    reduce = tuple(i for i in range(x.dim()) if i not in keep)
    if reduce:
        sf = _amax_sf(x, reduce, use_ue8m0)
    else:       # amax over no dim (torch's dim=() would reduce them all)
        sf = x.abs().float().clamp(min=FP8_AMAX_EPS) / FP8_MAX
        sf = ceil_to_ue8m0(sf) if use_ue8m0 else sf
    return cast_to_fp8(x * (1.0 / sf)), sf.squeeze()


def quantize_experts(w: torch.Tensor, transpose: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[E, N, K] bf16 -> (e4m3 [E, N, K], f32 128x128 block scales
    [E, N/128, K/128]); with ``transpose``, each expert's transpose
    [E, K, N] is cast instead, without a transposed copy of ``w``. A few
    experts at a time, so the f32 temporaries stay near ``_CHUNK_ELEMS``
    elements; bitwise what per_block_cast_to_fp8 gives expert by expert."""
    e_count = w.shape[0]
    n, k = w.shape[1:] if not transpose else w.shape[:0:-1]
    q = torch.empty((e_count, n, k), dtype=torch.float8_e4m3fn, device=w.device)
    sf = torch.empty((e_count, ceil_div(n, 128), ceil_div(k, 128)), dtype=torch.float32,
                     device=w.device)
    step = max(1, _CHUNK_ELEMS // max(1, n * k))
    for e0 in range(0, e_count, step):
        part = w[e0:e0 + step]
        q[e0:e0 + step], sf[e0:e0 + step] = per_block_cast_to_fp8(
            part.transpose(1, 2) if transpose else part, use_ue8m0=False)
    return q, sf
