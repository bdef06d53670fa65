"""Scale-factor layouts (counterpart of deepgemm_tpu/ops/sf_layout.py).

The kernels read SFA m-major ``[m, ksf]`` and SFB as the cast makes it for a
k-major B, ``[ceil(n/gran_n), ksf]``: one scale per ``gran_n`` rows of B
(128 for the 128 x 128 block scales, 1 per channel), so no layout step
expands it. The transforms here bring every accepted form there, as small
f32 / int32 tensor ops outside any kernel: packed-UE8M0 int32 scales
(4 exponents a word along k) are unpacked, and the scales of an MN-major
operand (``[ksf, m]``, ``[ksf, nsf]``, ``[G, ksf, nsf]``; packed: k packed
along the leading SF dim) are turned m-major. The public transforms and the
packed / MN-major / k-grouped helpers follow JAX's
(``sf_layout.py:86-208``).
"""

from typing import Optional, Sequence, Tuple

import torch

from ..utils.math import align, ceil_div, ceil_to_ue8m0, pack_ue8m0_to_int, unpack_ue8m0_from_int


def resolve_recipes(recipe, recipe_a, recipe_b
                    ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Resolve (recipe, recipe_a, recipe_b) into per-operand (gran_mn,
    gran_k). Default: A (1, 128), B (128, 128)."""
    if recipe is not None:
        assert recipe_a is None and recipe_b is None
        if len(recipe) == 3:
            # (gran_m, gran_n, gran_k): A (gran_m, gran_k), B (gran_n, gran_k)
            gm_a, gm_b, gk = recipe
            return (gm_a, gk), (gm_b, gk)
        assert len(recipe) == 2
        return tuple(recipe), tuple(recipe)
    if recipe_a is None and recipe_b is None:
        return (1, 128), (128, 128)
    assert recipe_a is not None and recipe_b is not None
    return tuple(recipe_a), tuple(recipe_b)


def unpack_sf(sf: torch.Tensor, ksf: int, k_last: bool = True) -> torch.Tensor:
    """Scales as f32 with ``ksf`` k blocks: packed-UE8M0 int32 words (4
    exponents each along k: the last dim, or with ``k_last=False`` the
    leading SF dim, as an MN-major operand's packed scales lie) unpacked and
    cut to ``ksf``; f32 scales as they are."""
    if sf.dtype == torch.int32:
        if k_last:
            sf = unpack_ue8m0_from_int(sf)[..., :ksf]
        else:
            sf = unpack_ue8m0_from_int(sf.transpose(-1, -2))[..., :ksf].transpose(-1, -2)
    return sf.float()


def transform_sfa(sfa: torch.Tensor, m: int, k: int, gran_k: int,
                  a_kmajor: bool = True) -> torch.Tensor:
    """SFA as contiguous f32 ``[m, ksf]``: given ``[m, ksf]`` for a k-major
    A, ``[ksf, m]`` for an MN-major one (f32 or packed UE8M0)."""
    ksf = ceil_div(k, gran_k)
    sfa = unpack_sf(sfa, ksf, k_last=a_kmajor)
    if not a_kmajor:
        assert tuple(sfa.shape) == (ksf, m), f'{tuple(sfa.shape)} != {(ksf, m)}'
        return sfa.t().contiguous()
    assert tuple(sfa.shape) == (m, ksf), f'{tuple(sfa.shape)} != {(m, ksf)}'
    return sfa.contiguous()


def transform_sfb(sfb: torch.Tensor, n: int, k: int, recipe_b: Tuple[int, int],
                  b_kmajor: bool = True, num_groups: Optional[int] = None) -> torch.Tensor:
    """SFB as contiguous f32 ``[nsf, ksf]`` (``[G, nsf, ksf]`` with
    ``num_groups``), the layout the kernels read: given so for a k-major B,
    ``[ksf, nsf]`` (``[G, ksf, nsf]``) for an MN-major one (f32 or packed
    UE8M0). nsf = ceil(n / gran_mn)."""
    gran_mn, gran_k = recipe_b
    nsf, ksf = ceil_div(n, gran_mn), ceil_div(k, gran_k)
    sfb = unpack_sf(sfb, ksf, k_last=b_kmajor)
    lead = () if num_groups is None else (num_groups,)
    if not b_kmajor:
        assert tuple(sfb.shape) == (*lead, ksf, nsf), f'{tuple(sfb.shape)} != {(*lead, ksf, nsf)}'
        sfb = sfb.transpose(-1, -2)
    assert tuple(sfb.shape) == (*lead, nsf, ksf), f'{tuple(sfb.shape)} != {(*lead, nsf, ksf)}'
    return sfb.contiguous()


def transform_sf_into_required_layout(sf: torch.Tensor, mn: Optional[int] = None,
                                      k: Optional[int] = None,
                                      recipe: Tuple[int, int] = (1, 128),
                                      is_sfa: bool = True,
                                      disable_ue8m0_cast: bool = True) -> torch.Tensor:
    """The f32 scales the kernels take (deepgemm_tpu/ops/sf_layout.py:86-103):
    packed UE8M0 unpacked, rounded up to powers of two unless
    ``disable_ue8m0_cast`` (which changes the values of data not quantized
    with such scales)."""
    del mn, k, recipe, is_sfa
    if sf.dtype == torch.int32:
        sf = unpack_ue8m0_from_int(sf)
    sf = sf.float()
    if not disable_ue8m0_cast:
        sf = ceil_to_ue8m0(sf)
    return sf


def transform_sf_pair_into_required_layout(sfa: torch.Tensor, sfb: torch.Tensor, m: int, n: int,
                                           k: int, recipe=None, recipe_a=None, recipe_b=None,
                                           disable_ue8m0_cast: bool = True):
    """The pair form (deepgemm_tpu/ops/sf_layout.py:106-120): the recipes
    resolved and both scales transformed; returns (sfa, sfb, gran_k_a,
    gran_k_b)."""
    recipe_a, recipe_b = resolve_recipes(recipe, recipe_a, recipe_b)
    sfa = transform_sf_into_required_layout(sfa, m, k, recipe_a, True, disable_ue8m0_cast)
    sfb = transform_sf_into_required_layout(sfb, n, k, recipe_b, False, disable_ue8m0_cast)
    return sfa, sfb, recipe_a[1], recipe_b[1]


def get_tma_aligned_size(x: int, element_size: int) -> int:
    """``x`` aligned to 16 bytes of ``element_size``-byte elements."""
    return align(x, 16 // element_size)


def get_mn_major_tma_aligned_tensor(sf: torch.Tensor) -> torch.Tensor:
    """f32 scales ``[mn, ksf]`` -> MN-major ``[ksf, mn]`` (batched
    ``[g, mn, ksf]`` -> ``[g, ksf, mn]``), contiguous."""
    assert sf.dtype == torch.float32 and sf.dim() in (2, 3)
    return sf.transpose(-1, -2).contiguous()


def get_mn_major_tma_aligned_packed_ue8m0_tensor(
        sf: torch.Tensor, psum_layout: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Power-of-two f32 scales ``[.., mn, ksf]`` -> their UE8M0 exponents
    packed 4 a word along k, ``[.., mn, ceil(ksf / 4)]`` int32 (the k tail
    padded with 1.0). ``psum_layout`` (per-group end rows) sets the rows at
    or past the last end to 1.0, the gap rows no kernel reads."""
    assert sf.dtype == torch.float32 and sf.dim() in (2, 3)
    pad = align(sf.shape[-1], 4) - sf.shape[-1]
    if pad:
        sf = torch.nn.functional.pad(sf, (0, pad), value=1.0)
    if psum_layout is not None:
        rows = torch.arange(sf.shape[-2], device=sf.device)[:, None]
        sf = torch.where(rows < psum_layout[-1], sf, torch.ones((), device=sf.device))
    return pack_ue8m0_to_int(sf.contiguous())


def get_k_grouped_mn_major_tma_aligned_packed_ue8m0_tensor(
        sf: torch.Tensor, ks: Sequence[int], gran_k: int = 128,
        k_alignment: int = 128) -> torch.Tensor:
    """k-grouped packed UE8M0: ``sf`` [mn, total_ksf], the per-group
    ``ceil(k_g / gran_k)`` segments one after another; each non-empty
    group's segment padded with 1.0 to a multiple of ``k_alignment /
    gran_k`` entries, then packed 4 a word."""
    assert sf.dtype == torch.float32 and sf.dim() == 2
    seg = max(k_alignment // gran_k, 1)
    pieces, off = [], 0
    for k_g in ks:
        n_g = ceil_div(k_g, gran_k)
        if k_g > 0:
            piece = sf[:, off:off + n_g]
            pad = align(max(n_g, 1), seg) - n_g
            if pad:
                piece = torch.nn.functional.pad(piece, (0, pad), value=1.0)
            pieces.append(piece)
        off += n_g
    packed = torch.cat(pieces, dim=1) if pieces else sf[:, :0]
    return get_mn_major_tma_aligned_packed_ue8m0_tensor(packed)


def check_k_grouped_packed_ue8m0_tensor(sf: torch.Tensor, ks: Sequence[int],
                                        gran_k: int = 128, k_alignment: int = 128) -> bool:
    """Raise unless ``sf`` has the shape of
    :func:`get_k_grouped_mn_major_tma_aligned_packed_ue8m0_tensor`'s result."""
    assert sf.dtype == torch.int32 and sf.dim() == 2
    assert k_alignment % 32 == 0
    seg = max(k_alignment // gran_k, 1)
    total = sum(align(ceil_div(k_g, gran_k), seg) for k_g in ks if k_g > 0)
    expected = ceil_div(total, 4)
    assert sf.shape[-1] == expected, (tuple(sf.shape), expected)
    return True
