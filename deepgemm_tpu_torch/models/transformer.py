"""Flagship model: a DeepSeek-V3-style MoE decoder on the port's kernels.
Counterpart of deepgemm_tpu/models/transformer.py at one rank: serving
(``forward``) and the SGD training step (``loss_fn``, ``train_step``).

RMSNorm -> attention -> RMSNorm -> top-k routed SwiGLU MoE, per layer.
Serving runs the expert GEMMs through the masked grouped kernel. FP8
training (``use_fp8_training``) runs the attention projections through the
differentiable FP8 dense op, and with ``use_kernels`` the expert GEMMs
through the differentiable FP8 grouped op (contiguous and k-grouped
kernels). Every other product is a plain f32 ``torch.matmul`` on upcast
bf16 operands, rounded to bf16 where the JAX model rounds (routing is a
top-k over ``x @ router.T``, so a rounding moved upstream can flip an
expert choice). On a CUDA card TF32 must stay off for those f32 products
(PyTorch's default).

With ``use_mega`` the MoE block runs the mega pipeline
(parallel/mega.py): 'xla', the unfused expert block (at one rank the
bits of the plain MoE path), 'pallas', the same over the one-sided
all-to-all kernel, or 'fused', the fused mega kernel in one launch a layer
a rank.

Serving over an expert-parallel mesh (``forward(..., mesh)``, a
parallel/dist.Mesh with axes ('dp', 'ep') or ('ep',)): the router and
the attention run once on the whole batch (dp = tp = 1, as JAX replicates
them), then the MoE block splits the flattened tokens over ('dp', 'ep')
and each layer's experts over 'ep' (JAX's ``param_shardings``), runs the
per-rank MoE on the mesh (one thread and stream a rank) and concatenates
the ranks' outputs. ``mesh=None`` is the one-rank path, bit for bit.

Parameters are a plain dict of tensors with the JAX package's layout;
models/convert.shard_experts cuts the expert weights for a mesh ahead of
time. Still to be ported: dp > 1 or tp > 1 meshes and the training step
over a mesh (ROADMAP.md).
"""

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from ..ops.autograd import fp8_dense
from ..parallel import dist
from ..parallel.dist import Mesh
from ..parallel.mega import mega_moe_forward
from ..parallel.moe import MoEConfig, ep_moe_forward
from ..runtime.config import resolve_device
from ..utils.math import _CHUNK_ELEMS, quantize_experts, topk_stable
from .convert import rank_experts, tree_leaves, tree_map

# f32 elements of cast temporaries a rank holds at once (quantize_experts)
# when ranks share a card and cast together: a quarter of one rank's. On an
# 80 GB H100 beside DeepSeek-V3's weights, eight ranks at the full chunk ran
# out of memory, and at an eighth each the casts' small launches from eight
# threads left the card idle 63% of the forward (chip_smoke.py phase 11).
_SHARED_CARD_CAST_ELEMS = _CHUNK_ELEMS // 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 32768
    hidden: int = 1024
    num_layers: int = 2
    num_heads: int = 8
    head_dim: int = 128
    num_experts: int = 8
    topk: int = 2
    moe_intermediate: int = 512
    capacity_factor: float = 4.0
    use_fp8: bool = False          # fp8 expert weights and activations (with use_kernels)
    use_kernels: bool = False      # see MoEConfig.use_kernels
    use_mega: bool = False         # the mega MoE pipeline (inference)
    mega_chunks: Optional[int] = None  # None or > 0; moves no bit at one rank
    mega_comm: str = 'xla'         # 'xla' | 'pallas' (the one-sided a2a; a mesh) | 'fused'
    # FP8 training: attention projections through the differentiable fp8
    # dense op; with use_kernels also the expert GEMMs through the grouped
    # autograd op (see MoEConfig.fp8_training)
    use_fp8_training: bool = False

    @property
    def qkv_dim(self):
        return self.num_heads * self.head_dim

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(num_experts=self.num_experts, hidden=self.hidden,
                         intermediate=self.moe_intermediate, topk=self.topk,
                         capacity_factor=self.capacity_factor,
                         use_fp8=self.use_fp8, use_kernels=self.use_kernels,
                         fp8_training=self.use_fp8_training and self.use_kernels)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Random weights made on ``device`` (default: the CUDA card) from a
    ``torch.Generator`` seeded with ``seed``, at the JAX package's scales:
    N(0, 1/fan_in) bf16 matrices, 0.02 for the embedding and the f32
    router, ones for the norms. Large tensors are drawn in chunks."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape, scale=None):
        scale = scale or (1.0 / math.sqrt(shape[-1]))
        out = torch.empty(shape, dtype=torch.bfloat16, device=dev)
        flat = out.view(-1, shape[-1])
        step = max(1, _CHUNK_ELEMS // shape[-1])
        for r0 in range(0, flat.shape[0], step):
            rows = min(step, flat.shape[0] - r0)
            draw = torch.randn((rows, shape[-1]), generator=gen, device=dev)
            flat[r0:r0 + rows] = (draw * scale).to(torch.bfloat16)
        return out

    params = {
        'embed': w(cfg.vocab, cfg.hidden, scale=0.02),
        'final_norm': torch.ones(cfg.hidden, dtype=torch.float32, device=dev),
        'layers': [],
    }
    for _ in range(cfg.num_layers):
        router = torch.randn((cfg.num_experts, cfg.hidden), generator=gen, device=dev) * 0.02
        params['layers'].append({
            'ln1': torch.ones(cfg.hidden, dtype=torch.float32, device=dev),
            'ln2': torch.ones(cfg.hidden, dtype=torch.float32, device=dev),
            'wqkv': w(3 * cfg.qkv_dim, cfg.hidden),
            'wo': w(cfg.hidden, cfg.qkv_dim),
            'router': router,
            'w1': w(cfg.num_experts, 2 * cfg.moe_intermediate, cfg.hidden),
            'w2': w(cfg.num_experts, cfg.hidden, cfg.moe_intermediate),
        })
    return params


def _linear_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., k] @ w [n, k]^T in f32 (bf16 operands upcast exactly)."""
    return torch.matmul(x.float(), w.float().t())


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * gamma).to(x.dtype)


def attention(x: torch.Tensor, wqkv: torch.Tensor, wo: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Causal multi-head attention, bf16 in and out, f32 inside; the two
    projections through the FP8 dense op with ``use_fp8_training``."""
    b, s, _ = x.shape
    if cfg.use_fp8_training:
        qkv = fp8_dense(x, wqkv)
    else:
        qkv = _linear_f32(x, wqkv).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, cfg.num_heads, cfg.head_dim)
               for t in qkv.split(cfg.qkv_dim, dim=-1))
    scores = torch.einsum('bqnd,bknd->bnqk', q.float(), k.float())
    scores = scores / math.sqrt(cfg.head_dim)
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float('-inf'))
    probs = torch.softmax(scores, dim=-1).to(torch.bfloat16)
    ctx = torch.einsum('bnqk,bknd->bqnd', probs.float(), v.float()).to(torch.bfloat16)
    ctx = ctx.reshape(b, s, cfg.qkv_dim)
    if cfg.use_fp8_training:
        return fp8_dense(ctx, wo)
    return _linear_f32(ctx, wo).to(torch.bfloat16)


def moe_block(x: torch.Tensor, layer: Dict[str, Any], cfg: ModelConfig,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Router + MoE, at one rank or over ``mesh`` (see the module
    docstring). On the FP8 serving path (``use_fp8`` and ``use_kernels``,
    not training) the expert weights are quantized in this call, each
    rank its own, as the JAX model does, and freed on return; the fused
    mega path takes them without a repack (its kernel pairs gate and up
    rows by address). FP8 training quantizes inside the grouped autograd
    op, so the weights stay bf16 leaves that receive their gradients."""
    b, s, h = x.shape
    tokens = x.reshape(b * s, h)
    logits = tokens.float() @ layer['router'].t()
    # JAX's tie rule (lax.top_k): equal logits route to the lower expert
    topk_w, topk_idx = topk_stable(logits, cfg.topk)
    topk_w = torch.softmax(topk_w, dim=-1)
    moe_cfg = cfg.moe_cfg()

    def fwd(tok, idx, ww, w1, w2):
        w1_sf = w2_sf = None
        if cfg.use_fp8 and cfg.use_kernels and not moe_cfg.fp8_training:
            shared = mesh is not None and mesh.ranks_on_device(dist.current()[1]) > 1
            chunk = _SHARED_CARD_CAST_ELEMS if shared else _CHUNK_ELEMS
            w1, w1_sf = quantize_experts(w1, chunk_elems=chunk)
            w2, w2_sf = quantize_experts(w2, chunk_elems=chunk)
        if cfg.use_mega:
            y, _ = mega_moe_forward(tok, idx, ww, w1, w1_sf, w2, w2_sf, moe_cfg,
                                    num_chunks=cfg.mega_chunks, comm=cfg.mega_comm)
        else:
            y, _ = ep_moe_forward(tok, idx, ww, w1, w1_sf, w2, w2_sf, moe_cfg)
        return y

    if mesh is None:
        y = fwd(tokens, topk_idx, topk_w, layer['w1'], layer['w2'])
    else:
        n = mesh.size
        if tokens.shape[0] % n:
            raise ValueError(f'{tokens.shape[0]} tokens do not split over {n} ranks')
        shard = lambda t: [c.to(d) for c, d in zip(t.chunk(n), mesh.devices)]
        ys = mesh.map(fwd, shard(tokens), shard(topk_idx), shard(topk_w),
                      rank_experts(layer['w1'], mesh), rank_experts(layer['w2'], mesh))
        y = torch.cat([v.to(x.device) for v in ys])
    return y.reshape(b, s, h)


def logits_fn(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
              mesh: Optional[Mesh] = None) -> torch.Tensor:
    """tokens [b, s] int -> logits [b, s, vocab] f32, on the parameters'
    device; differentiable at one rank (the JAX package's ``forward``)."""
    embed = params['embed']
    x = embed[tokens.to(embed.device)]
    for layer in params['layers']:
        x = x + attention(rms_norm(x, layer['ln1']), layer['wqkv'], layer['wo'], cfg)
        x = x + moe_block(rms_norm(x, layer['ln2']), layer, cfg, mesh)
    x = rms_norm(x, params['final_norm'])
    return _linear_f32(x, embed)


@torch.no_grad()
def forward(params: Dict[str, Any], tokens: torch.Tensor, cfg: ModelConfig,
            mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Serving: :func:`logits_fn` without an autograd graph; over ``mesh``
    when given (the expert-parallel serving forward)."""
    return logits_fn(params, tokens, cfg, mesh)


def loss_fn(params: Dict[str, Any], tokens: torch.Tensor, targets: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """Mean next-token negative log-likelihood, f32 scalar."""
    logp = torch.log_softmax(logits_fn(params, tokens, cfg), dim=-1)
    targets = targets.to(logp.device).long()
    return -logp.gather(-1, targets[..., None]).mean()


def _sgd_(p: torch.Tensor, g: torch.Tensor, lr: float):
    """p <- (p.f32 - lr * g.f32).to(p.dtype) in place, a slice of the leading
    dim at a time (one expert of an expert weight, or rows of the embedding):
    elementwise, so no bit changes, and the f32 temporaries stay small."""
    rows = p.shape[0] if p.dim() else 1
    pv, gv = p.view(rows, -1), g.reshape(rows, -1)
    step = max(1, _CHUNK_ELEMS // max(1, pv.shape[1]))
    for r0 in range(0, rows, step):
        sl = slice(r0, r0 + step)
        pv[sl] = (pv[sl].float() - lr * gv[sl].float()).to(p.dtype)


def train_step(params: Dict[str, Any], tokens: torch.Tensor, targets: torch.Tensor,
               cfg: ModelConfig, lr: float = 1e-3) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One SGD step: returns (the loss before the step, the parameters).

    The new parameters are ``(p.f32 - lr * g.f32).to(p.dtype)`` as in the
    JAX package, but written IN PLACE into ``params`` (which is returned):
    at DeepSeek-V3 widths a second copy of the weights would not fit beside
    the weights and their gradients on one card. Each gradient is freed
    once its parameter is updated."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]     # aliases, same storage
    it = iter(live)
    loss = loss_fn(tree_map(lambda _: next(it), params), tokens, targets, cfg)
    grads = list(torch.autograd.grad(loss, live))
    del live
    with torch.no_grad():
        for i, p in enumerate(leaves):
            _sgd_(p, grads[i], lr)
            grads[i] = None
    return loss.detach(), params
