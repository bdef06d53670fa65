"""Kernel timing on the card with CUDA events.

Before each timed launch a buffer larger than the H100's 50 MB L2 is
written, so every launch finds its inputs cold, as a caller whose working
set exceeds the cache does. Each launch is bracketed by its own two events
(the flush stays outside them) and the times are averaged."""

from typing import Callable

import torch

_L2_FLUSH_BYTES = 256 << 20


def bench_kernel(fn: Callable[[], object], iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of one ``fn()`` on the current CUDA stream, with
    the L2 cache flushed before each launch."""
    if not torch.cuda.is_available():
        raise RuntimeError('bench_kernel times the CUDA card; none is present')
    for _ in range(warmup):
        fn()
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8, device='cuda')
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters
