"""Mega MoE pipeline heuristics. Counterpart of
deepgemm_tpu/heuristics/mega.py:1-79, with JAX's rule unchanged.

The chunked 'xla'/'pallas' pipeline hides chunk c's all-to-alls under chunk
c-1's expert GEMMs, so the exposed communication is about the first
chunk's dispatch and the last chunk's combine, ``t_comm / num_chunks``
each. More chunks shrink that bubble but fragment the grouped GEMMs; stop
at a few token-alignment units, and do not chunk when communication is a
small fraction of compute.

The link is the H100's NVLink, 450 GB/s each way (``ArchSpec.
link_bytes_per_s``), in the place of the TPU's ICI rate, and the peak is the
card's rate for the operand type. Ranks that share one card move their
bytes through its HBM, far faster than the link; the rule still models
the link, the placement a deployment of D ranks has (one card each).
"""

import dataclasses
from typing import Optional

from ..utils.math import ceil_div
from .arch import ArchSpec, detect_arch

# Chunks should not shrink below a few slot-alignment units (8 rows).
_MIN_CHUNK_ROWS = 16
_MAX_CHUNKS = 8


@dataclasses.dataclass(frozen=True)
class MegaMoEConfig:
    num_chunks: int            # dispatch/combine pipeline granularity
    chunk_rows: int            # capacity rows per chunk
    expected_m: int            # tokens-per-expert hint
    comm_compute_ratio: float  # modeled t_dispatch+combine / t_expert_gemms


def get_mega_moe_config(num_tokens_per_rank: int, hidden: int, intermediate: int,
                        num_experts: int, num_ranks: int, topk: int, capacity: int,
                        use_fp8: bool = True, arch: Optional[ArchSpec] = None) -> MegaMoEConfig:
    """Size the chunked mega pipeline (JAX's policy; see the module
    docstring)."""
    arch = arch or detect_arch()
    e_local = max(1, num_experts // max(1, num_ranks))
    expected_m = max(1, ceil_div(num_tokens_per_rank * topk, num_experts))
    # per-rank modeled times over one step (all experts, full capacity)
    rows = num_ranks * capacity * e_local
    x_bytes = 1 if use_fp8 else 2
    remote_frac = (num_ranks - 1) / max(1, num_ranks)
    # dispatch (tokens, x_bytes wide) + combine (bf16 partials back)
    comm_bytes = remote_frac * rows * hidden * (x_bytes + 2)
    flops = 2 * rows * (2 * intermediate * hidden + hidden * intermediate)
    peak = arch.fp8_flops if use_fp8 else arch.bf16_flops
    t_comm = comm_bytes / arch.link_bytes_per_s
    t_comp = flops / (peak * 0.7)          # grouped-GEMM efficiency derate
    ratio = t_comm / max(t_comp, 1e-12)
    if ratio < 0.05:
        chunks = 1                         # the bubble is already negligible
    else:
        chunks = ceil_div(int(ratio * 100), 12)   # exposed bubble under ~12% of compute
    chunks = max(1, min(chunks, _MAX_CHUNKS, capacity // _MIN_CHUNK_ROWS))
    return MegaMoEConfig(num_chunks=chunks, chunk_rows=ceil_div(capacity, chunks),
                         expected_m=expected_m, comm_compute_ratio=round(ratio, 4))
