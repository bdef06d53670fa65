"""Einsum API (counterpart of deepgemm_tpu/ops/einsum.py).

  * ``einsum`` over the reference's three expressions, bf16 operands:
    ``bmk,bnk->mn`` (f32 out needs ``c``: ``out + c``), ``bhr,hdr->bhd`` and
    ``bhd,hdr->bhr``. JAX leaves them to XLA's dot, so they are torch calls
    here: f32 products of the upcast operands (exact) with f32 sums, TF32
    off.
  * ``fp8_bmm``: ``[B, m, k] @ [B, n, k]^T`` of e4m3 operands with f32 (or
    packed UE8M0) scales on the masked grouped kernel with every row live;
    with ``c`` the kernel's f32 instance gives the promoted sum before
    ``+ c``. The kernel reads B's block scales ``[B, nsf, ksf]`` as they are.
  * ``fp8_einsum``: the three expressions as permuted ``fp8_bmm`` calls;
    each operand and its scales are permuted with it and made contiguous
    (the kernel's operands are). Each expression's scales are the
    per-token (1 x 128) ones of its permuted A and the 128 x 128 block ones
    of its permuted B.
"""

import torch

from ..kernels.common import f32_products
from ..kernels.grouped import masked_gemm
from ..utils.math import ceil_div, unpack_ue8m0_from_int
from .gemm import _out_dtype_of, _split_pair
from .sf_layout import resolve_recipes, transform_sfb

_OUT_DTYPES = (torch.bfloat16, torch.float32)


def _bmk_bnk_mn(a, b, d, c):
    with f32_products():
        out = torch.einsum('bmk,bnk->mn', a.float(), b.float())
    if _out_dtype_of(d, _OUT_DTYPES) == torch.float32:
        assert c is not None, 'FP32 bmk,bnk->mn requires accumulation (c = d)'
        return out + c
    assert c is None
    return out.to(torch.bfloat16)


def einsum(expr: str, a: torch.Tensor, b: torch.Tensor, d=None, c=None,
           use_cublaslt: bool = False) -> torch.Tensor:
    """bf16 einsum over the reference's expression set; ``use_cublaslt`` is
    accepted for the API's sake."""
    del use_cublaslt
    if expr == 'bmk,bnk->mn':
        return _bmk_bnk_mn(a, b, d, c)
    if expr in ('bhr,hdr->bhd', 'bhd,hdr->bhr'):
        assert c is None
        with f32_products():
            return torch.einsum(expr, a.float(), b.float()).to(torch.bfloat16)
    raise ValueError(f'Unsupported einsum expression: {expr}')


def _f32_scales(sf: torch.Tensor, ksf: int) -> torch.Tensor:
    """f32 scales, packed UE8M0 int32 ones unpacked along k."""
    if sf.dtype == torch.int32:
        sf = unpack_ue8m0_from_int(sf)[..., :ksf]
    return sf.float().contiguous()


def fp8_bmm(a: torch.Tensor, sfa: torch.Tensor, b: torch.Tensor, sfb: torch.Tensor,
            d=None, c=None, recipe=None, compiled_dims='nk') -> torch.Tensor:
    """Batched FP8 GEMM ``d[B, m, n] = a[B, m, k] @ b[B, n, k]^T`` with the
    f32 promotion, then ``+ c`` in f32 when given."""
    del compiled_dims
    batch, m, k = a.shape
    n = b.shape[1]
    out_dtype = _out_dtype_of(d, _OUT_DTYPES)
    recipe_a, recipe_b = resolve_recipes(recipe, None, None)
    if recipe_a[1] != 128 or recipe_b[1] != 128:
        raise NotImplementedError(f'only gran_k 128 is ported (got {recipe_a}, {recipe_b})')
    ksf = ceil_div(k, 128)
    sfb = transform_sfb(_f32_scales(sfb, ksf), n, k, recipe_b, num_groups=batch)
    full = torch.full((batch,), m, dtype=torch.int32, device=a.device)
    out = masked_gemm(a.contiguous(), b.contiguous(), full, sfa=_f32_scales(sfa, ksf),
                      sfb=sfb, gran_n=recipe_b[0],
                      out_dtype=torch.float32 if c is not None else out_dtype)
    if c is not None:
        out = (out + c).to(out_dtype)
    return out


def fp8_einsum(expr: str, a, b, d=None, c=None, recipe=(1, 128, 128)) -> torch.Tensor:
    """FP8 einsum through a permuted :func:`fp8_bmm` (batch, m, n, k):

    * ``bhr,hdr->bhd``: (h, b, d, r); a's scales [b, h, ceil(r/128)], b's
      [h, ceil(d/128), ceil(r/128)];
    * ``bhd,hdr->bhr``: (h, b, r, d); a's scales [b, h, ceil(d/128)], b's
      [h, ceil(d/128), ceil(r/128)];
    * ``bhd,bhr->hdr``: (h, d, r, b); a's scales [ceil(b/128), h, d], b's
      [ceil(b/128), h, ceil(r/128)]."""
    a_val, sfa = _split_pair(a)
    b_val, sfb = _split_pair(b)
    if expr == 'bhr,hdr->bhd':
        a_dims, b_dims, out_dims = (1, 0, 2), (0, 1, 2), (1, 0, 2)
    elif expr == 'bhd,hdr->bhr':
        a_dims, b_dims, out_dims = (1, 0, 2), (0, 2, 1), (1, 0, 2)
    elif expr == 'bhd,bhr->hdr':
        a_dims, b_dims, out_dims = (1, 2, 0), (1, 2, 0), None
    else:
        raise ValueError(f'Unsupported fp8 einsum expression: {expr}')
    if c is not None and out_dims is not None:
        c = c.permute(out_dims)
    out = fp8_bmm(a_val.permute(a_dims), sfa.permute(a_dims), b_val.permute(b_dims),
                  sfb.permute(b_dims), d=d, c=c, recipe=recipe)
    return out if out_dims is None else out.permute(out_dims)
