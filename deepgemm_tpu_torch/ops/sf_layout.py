"""Scale-factor layouts (counterpart of deepgemm_tpu/ops/sf_layout.py) for
f32 scales and k-major (NT) operands.

The kernels read SFA m-major ``[m, ksf]`` and SFB as the cast makes it,
``[ceil(n/gran_n), ksf]``: one scale per ``gran_n`` rows of B (128 for the
128 x 128 block scales, 1 per channel), so no layout step expands it.
Packed-UE8M0 int32 scales and the other layouts are not ported yet.
"""

from typing import Optional, Tuple

import torch

from ..utils.math import ceil_div


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


def _require_f32(sf: torch.Tensor, name: str):
    if sf.dtype != torch.float32:
        raise NotImplementedError(
            f'{name}: only f32 scales are ported (got {sf.dtype}); packed '
            f'UE8M0 int32 scales come in a later slice')


def transform_sfa(sfa: torch.Tensor, m: int, k: int, gran_k: int) -> torch.Tensor:
    """SFA of a k-major A as f32 ``[m, ksf]``."""
    _require_f32(sfa, 'sfa')
    ksf = ceil_div(k, gran_k)
    assert tuple(sfa.shape) == (m, ksf), f'{tuple(sfa.shape)} != {(m, ksf)}'
    return sfa.contiguous()


def transform_sfb(sfb: torch.Tensor, n: int, k: int, recipe_b: Tuple[int, int],
                  num_groups: Optional[int] = None) -> torch.Tensor:
    """SFB of a k-major B as f32 ``[nsf, ksf]`` (``[G, nsf, ksf]`` with
    ``num_groups``), the layout the kernels read."""
    _require_f32(sfb, 'sfb')
    gran_mn, gran_k = recipe_b
    shape = (ceil_div(n, gran_mn), ceil_div(k, gran_k))
    if num_groups is not None:
        shape = (num_groups, *shape)
    assert tuple(sfb.shape) == shape, f'{tuple(sfb.shape)} != {shape}'
    return sfb.contiguous()
