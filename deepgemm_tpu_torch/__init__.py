"""deepgemm_tpu_torch: the PyTorch/CUDA port of deepgemm_tpu for one NVIDIA
H100 (sm_90a).

It holds the FP8 dense GEMM in every layout (NT, NN, TN, TT; C
accumulation; the 'promote' and 'dequant' scale strategies; f32 or packed
UE8M0 scales; packed FP4 operands folded in, planar FP4 B decoded in the
kernel; the skip-head-mid form), the masked grouped GEMM (with fp8_bmm and
fp8_einsum on it) and the contiguous grouped GEMM (NT with its dual-B form,
and NN), the k-grouped GEMM (TN, and the flattened NT form), the runtime
knobs and the scale-layout transforms, the TF32 HyperConnection prenorm GEMM, the indexer's MQA
logits (prefill and paged decode; e4m3, or FP4 operands decoded into bf16)
and the sparse attention over the selected rows, gathered or read in place from the
cache (each a hand-written CUDA kernel with a plain PyTorch version beside
it), the fused MoE expert block of the mega MoE (L1, SwiGLU, L2 in one kernel;
bf16, FP8 or planar FP4 weights), the quantization contract with the FP4
casts and packers, the differentiable FP8 matmuls, the MoE transformer at
one rank (the serving forward, with the mega MoE, and the FP8 SGD training
step) and the continuous-batching serving engine over the lightning
indexer.
Entry points run on the CUDA card unless the caller passes ``device='cpu'``.
Importing the package builds and loads nothing: kernels build at first use.
"""

from . import testing, utils
from .kernels.common import plain_versions
from .kernels.dense import dense_fp8_gemm_nt, dense_gemm
from .kernels.fused_moe import MegaPackedWeights, pack_mega_weights
from .kernels.grouped import contiguous_dual_gemm, contiguous_gemm, masked_gemm
from .kernels.hc_prenorm import hc_prenorm_gemm
from .kernels.k_grouped import k_grouped_gemm
from .models.indexer import indexer_sparse_attention, indexer_sparse_decode
from .models.transformer import (ModelConfig, forward, init_params, loss_fn,
                                 train_step)
from .ops.attention import (clean_logits_, fp8_fp4_mqa_logits,
                            fp8_fp4_paged_mqa_logits, fp8_mqa_logits,
                            fp8_paged_mqa_logits, get_paged_mqa_logits_metadata,
                            split_fused_kv_cache)
from .ops.autograd import fp8_dense, fp8_grouped_matmul, fp8_matmul
from .ops.einsum import einsum, fp8_bmm, fp8_einsum
from .ops.gemm import (bf16_gemm_nn, bf16_gemm_nt, bf16_gemm_tn, bf16_gemm_tt, cublaslt_gemm,
                      cublaslt_gemm_nn, cublaslt_gemm_nt, cublaslt_gemm_tn, cublaslt_gemm_tt,
                      fp8_fp4_gemm_nn, fp8_fp4_gemm_nt, fp8_fp4_gemm_tn, fp8_fp4_gemm_tt,
                      fp8_gemm_nn, fp8_gemm_nt, fp8_gemm_nt_skip_head_mid, fp8_gemm_tn,
                      fp8_gemm_tt)
from .ops.hyperconnection import tf32_hc_prenorm_gemm
from .ops.k_grouped import (k_grouped_bf16_gemm_tn_contiguous,
                            k_grouped_fp8_gemm_nt_contiguous,
                            k_grouped_fp8_gemm_tn_contiguous)
from .ops.m_grouped import (m_grouped_bf16_gemm_nn_contiguous,
                            m_grouped_bf16_gemm_nt_contiguous,
                            m_grouped_bf16_gemm_nt_masked,
                            m_grouped_fp8_fp4_gemm_nn_contiguous,
                            m_grouped_fp8_fp4_gemm_nt_contiguous,
                            m_grouped_fp8_fp4_gemm_nt_masked,
                            m_grouped_fp8_gemm_nn_contiguous,
                            m_grouped_fp8_gemm_nt_contiguous,
                            m_grouped_fp8_gemm_nt_masked)
from .ops.sf_layout import transform_sf_into_required_layout
from .parallel import mega
from .parallel.mega import (SymmBuffer, bf16_mega_moe, fp8_fp4_mega_moe,
                            get_ring_limit_for_mega_moe, get_symm_buffer_size_for_mega_moe,
                            get_token_alignment_for_mega_moe, transform_weights_for_mega_moe)
from .runtime.config import (get_mk_alignment_for_contiguous_layout, get_num_sms, get_pdl,
                             get_tc_util, resolve_device, set_block_size_multiple_of,
                             set_ignore_compile_dims, set_mk_alignment_for_contiguous_layout,
                             set_num_sms, set_pdl, set_tc_util)
from .serving import ContinuousBatcher, PageAllocator, PagedCache, SequenceState
from .testing.numeric import calc_diff
from .utils.math import (align, cast_back_from_fp4, ceil_div, ceil_to_ue8m0,
                         pack_fp4_planar, pack_ue8m0_to_int, per_block_cast_to_fp8,
                         per_channel_cast_to_fp8, per_custom_dims_cast_to_fp8,
                         per_token_cast_to_fp4, per_token_cast_to_fp8, quantize_experts,
                         repack_fp4_to_planar, transpose_packed_fp4, unpack_fp4_planar,
                         unpack_ue8m0_from_int)

# the reference's Python-level name (deep_gemm/__init__.py)
get_symm_buffer_for_mega_moe = SymmBuffer
# the legacy aliases (deepgemm_tpu/__init__.py:77-78)
fp8_m_grouped_gemm_nt_masked = m_grouped_fp8_gemm_nt_masked
bf16_m_grouped_gemm_nt_masked = m_grouped_bf16_gemm_nt_masked

__version__ = '0.1.0'
