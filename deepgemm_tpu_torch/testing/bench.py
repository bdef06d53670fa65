"""Kernel timing on the card.

``bench_kernel`` times with CUDA events. Before each timed launch a buffer
larger than the H100's 50 MB L2 is written, so every launch finds its inputs
cold, as a caller whose working set exceeds the cache does. Each launch is
bracketed by its own two events (the flush stays outside them) and the
times are averaged: the call's time, which is the host's where a wrapper's
host work outlasts the flush and its kernel. With ``hide_host`` the card is
held in ``torch.cuda._sleep`` before the start event, so the host work runs
under the sleep and the events bracket the device's work alone.
``bench_host`` times the host work of a call, not waiting for the device.

``bench_profiled`` (counterpart of deepgemm_tpu/testing/bench.py) sums the
device time of the kernels whose names match, from a ``torch.profiler``
trace. It raises when no kernel matches: it never falls back to wall time,
which would hide a kernel that did not run."""

import statistics
import time
from typing import Callable, Optional

import torch

_L2_FLUSH_BYTES = 256 << 20
_SLEEP_CYCLES = 600_000      # ~0.3 ms of the H100's clock: longer than a wrapper's host work


def bench_kernel(fn: Callable[[], object], iters: int = 10, warmup: int = 2,
                 hide_host: bool = False) -> float:
    """Mean milliseconds of one ``fn()`` on the current CUDA stream, with
    the L2 cache flushed before each launch; with ``hide_host`` the device's
    work alone (see the module's notes)."""
    if not torch.cuda.is_available():
        raise RuntimeError('bench_kernel times the CUDA card; none is present')
    for _ in range(warmup):
        fn()
    flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8, device='cuda')
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(_SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def bench_host(fn: Callable[[], object], calls: int = 100, batches: int = 5) -> float:
    """Milliseconds of host work in one ``fn()``: the median over
    ``batches`` of the mean of ``calls`` calls made without waiting for the
    device (it is synchronized between batches)."""
    if not torch.cuda.is_available():
        raise RuntimeError('bench_host times calls to the CUDA card; none is present')
    fn()
    means = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        means.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    return statistics.median(means)


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
