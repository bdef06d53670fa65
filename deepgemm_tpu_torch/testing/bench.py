"""Kernel timing on the card.

``bench_kernel`` times with CUDA events. Before each timed launch a buffer
larger than the H100's 50 MB L2 is written, so every launch finds its inputs
cold, as a caller whose working set exceeds the cache does. Each launch is
bracketed by its own two events (the flush stays outside them) and the
times are averaged.

``bench_profiled`` (counterpart of deepgemm_tpu/testing/bench.py) sums the
device time of the kernels whose names match, from a ``torch.profiler``
trace. It raises when no kernel matches: it never falls back to wall time,
which would hide a kernel that did not run."""

from typing import Callable, Optional

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


def bench_profiled(fn: Callable[[], object], kernel_name_filter: Optional[str] = None,
                   num_tests: int = 10) -> float:
    """Device seconds per call of ``fn`` spent in the kernels whose names
    contain ``kernel_name_filter`` (every device event when None), from a
    ``torch.profiler`` trace of ``num_tests`` calls after one warm-up call."""
    if not torch.cuda.is_available():
        raise RuntimeError('bench_profiled times the CUDA card; none is present')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(num_tests):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and (kernel_name_filter is None or kernel_name_filter in e.name))
    if not total_us:
        raise RuntimeError(f'the profiler saw no device kernel matching {kernel_name_filter!r}')
    return total_us / num_tests / 1e6
