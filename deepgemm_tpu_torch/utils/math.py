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


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of each row of ``x`` (last dim) and their
    positions, in ``jax.lax.top_k``'s order: descending, equal values
    toward the lower position. ``torch.topk`` promises no tie rule, and
    exact ties are common (a zero hidden row ties every router logit; an
    indexer position whose heads all fall below zero scores 0); a stable
    descending sort gives JAX's choice and order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    # through a flat view: a contiguous tensor may keep any stride on a dim of size 1
    flat = packed_sf.contiguous().view(-1).view(torch.uint8)
    exp = flat.to(torch.int32).view(*packed_sf.shape[:-1], 4 * packed_sf.shape[-1])
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


def quantize_experts(w: torch.Tensor, transpose: bool = False,
                     chunk_elems: int = _CHUNK_ELEMS) -> Tuple[torch.Tensor, torch.Tensor]:
    """[E, N, K] bf16 -> (e4m3 [E, N, K], f32 128x128 block scales
    [E, N/128, K/128]); with ``transpose``, each expert's transpose
    [E, K, N] is cast instead, without a transposed copy of ``w``. A few
    experts at a time, so the f32 temporaries stay near ``chunk_elems``
    elements (the ranks of a mesh that share a card cast at once and split
    the budget); bitwise what per_block_cast_to_fp8 gives expert by
    expert, whatever the chunk."""
    e_count = w.shape[0]
    n, k = w.shape[1:] if not transpose else w.shape[:0:-1]
    q = torch.empty((e_count, n, k), dtype=torch.float8_e4m3fn, device=w.device)
    sf = torch.empty((e_count, ceil_div(n, 128), ceil_div(k, 128)), dtype=torch.float32,
                     device=w.device)
    step = max(1, chunk_elems // max(1, n * k))
    for e0 in range(0, e_count, step):
        part = w[e0:e0 + step]
        q[e0:e0 + step], sf[e0:e0 + step] = per_block_cast_to_fp8(
            part.transpose(1, 2) if transpose else part, use_ue8m0=False)
    return q, sf


# ---------------------------------------------------------------------------
# FP4 (e2m1): codes in int8 bytes, two a byte (deepgemm_tpu/utils/math.py:140-274)
# ---------------------------------------------------------------------------

FP4_MAX = 6.0       # max magnitude of e2m1
_FP4_VALUES = (0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0)
# midpoints between consecutive e2m1 magnitudes (round-to-nearest boundaries)
_FP4_BOUNDARIES = (0.25, 0.75, 1.25, 1.75, 2.5, 3.5, 5.0)


def _quantize_to_fp4_e2m1(x: torch.Tensor) -> torch.Tensor:
    """f32 -> e2m1 4-bit codes (sign bit 3, magnitude bits 0-2), int8."""
    ax = x.abs()
    code = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for boundary in _FP4_BOUNDARIES:
        code += (ax > boundary).to(torch.int32)
    sign = (x < 0) & (code != 0)
    return (code | (sign.to(torch.int32) << 3)).to(torch.int8)


def _dequantize_from_fp4_e2m1(codes: torch.Tensor) -> torch.Tensor:
    """4-bit e2m1 codes (any int type) -> f32 values; code 0x8 gives +0."""
    codes = codes.to(torch.int32)
    value_idx = codes & 0x07
    sign = (codes & 0x08) != 0
    table = torch.tensor(_FP4_VALUES, dtype=torch.float32, device=codes.device)
    value = table[value_idx.long()]
    return torch.where(sign & (value_idx != 0), -value, value)


def _pack_nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return ((lo & 0x0F) | ((hi & 0x0F) << 4)).to(torch.int8)


def per_token_cast_to_fp4(x: torch.Tensor, use_ue8m0: bool, gran_k: int = 128,
                          use_packed_ue8m0: bool = False
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """1 x gran_k FP4 quantization; codes packed two a byte along n, the
    first in the low nibble. SF [m, ceil(n / gran_k)] f32, or packed UE8M0
    int32 (padded with 1.0 to a multiple of 4 scales)."""
    m, n = x.shape
    assert n % 2 == 0
    assert not use_packed_ue8m0 or use_ue8m0
    padded_n = align(n, gran_k)
    x_view = F.pad(x, (0, padded_n - n)).reshape(m, -1, gran_k)
    amax = x_view.abs().float().amax(dim=2).clamp(min=FP8_AMAX_EPS)
    sf = amax / FP4_MAX
    sf = ceil_to_ue8m0(sf) if use_ue8m0 else sf
    codes = _quantize_to_fp4_e2m1(x_view * (1.0 / sf)[:, :, None])
    codes2 = codes.reshape(m, padded_n // 2, 2).to(torch.int32)
    packed = _pack_nibbles(codes2[:, :, 0], codes2[:, :, 1])[:, :n // 2]
    if use_packed_ue8m0:
        num_sf = sf.shape[-1]
        if num_sf % 4:
            sf = F.pad(sf, (0, align(num_sf, 4) - num_sf), value=1.0)
        return packed.contiguous(), pack_ue8m0_to_int(sf)
    return packed.contiguous(), sf


def unpack_fp4_codes(packed: torch.Tensor) -> torch.Tensor:
    """int8 packed codes [.., n/2] -> int32 codes [.., n] (low nibble first)."""
    p = packed.to(torch.int32)
    codes = torch.stack([p & 0x0F, (p >> 4) & 0x0F], dim=-1)
    return codes.reshape(*packed.shape[:-1], packed.shape[-1] * 2)


def transpose_packed_fp4(a: torch.Tensor) -> torch.Tensor:
    """Transpose a 2D packed-FP4 code matrix [m, n/2] -> [n, m/2]."""
    assert a.dtype == torch.int8 and a.dim() == 2
    m, n2 = a.shape
    assert m % 2 == 0
    codes_t = unpack_fp4_codes(a).t().reshape(n2 * 2, m // 2, 2)
    return _pack_nibbles(codes_t[:, :, 0], codes_t[:, :, 1])


def pack_fp4_planar(codes: torch.Tensor) -> torch.Tensor:
    """e2m1 codes [.., k] (k % 256 == 0) -> the planar-128 int8 layout
    [.., k/2]: within each 256-code group, byte j holds codes j (low
    nibble) and 128 + j (high nibble)."""
    k = codes.shape[-1]
    assert k % 256 == 0, k
    c = codes.to(torch.int32).reshape(*codes.shape[:-1], k // 256, 2, 128)
    return _pack_nibbles(c[..., 0, :], c[..., 1, :]).reshape(*codes.shape[:-1], k // 2)


def unpack_fp4_planar(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_fp4_planar` -> int32 codes [.., k]."""
    k2 = packed.shape[-1]
    p = packed.to(torch.int32).reshape(*packed.shape[:-1], k2 // 128, 128)
    return torch.stack([p & 0x0F, (p >> 4) & 0x0F], dim=-2).reshape(*packed.shape[:-1], k2 * 2)


def repack_fp4_to_planar(packed_interleaved: torch.Tensor) -> torch.Tensor:
    """Adjacent-pair packing (:func:`per_token_cast_to_fp4`) -> planar-128."""
    return pack_fp4_planar(unpack_fp4_codes(packed_interleaved))


def cast_back_from_fp4(packed: torch.Tensor, sf: torch.Tensor, gran_k: int = 128,
                       use_packed_ue8m0: bool = False) -> torch.Tensor:
    """Dequantize packed FP4 [m, n/2] + SF back to f32 [m, n]."""
    n = packed.shape[1] * 2
    if use_packed_ue8m0:
        sf = unpack_ue8m0_from_int(sf)
    values = _dequantize_from_fp4_e2m1(unpack_fp4_codes(packed))
    group_idx = torch.arange(n, device=packed.device) // gran_k
    return values * sf[:, group_idx]


def decode_fp4_rows(packed: torch.Tensor, sf, gran_k: int) -> torch.Tensor:
    """Packed e2m1 rows [..., k/2] (int8) times their scales -> bf16
    [..., k]: the JAX package's fold of a packed FP4 operand
    (deepgemm_tpu/ops/gemm.py:_fold_fp4). ``sf`` is f32 [..., ceil(k/gran_k)],
    packed UE8M0 int32 [..., words], or None (the codes' values unscaled).
    Exact for power-of-two scales: an e2m1 value times a power of two fits
    bf16."""
    lead = packed.shape[:-1]
    flat = packed.reshape(-1, packed.shape[-1])
    if sf is None:
        values = _dequantize_from_fp4_e2m1(unpack_fp4_codes(flat))
    else:
        values = cast_back_from_fp4(flat, sf.reshape(flat.shape[0], -1), gran_k=gran_k,
                                    use_packed_ue8m0=sf.dtype == torch.int32)
    return values.to(torch.bfloat16).reshape(*lead, -1)
