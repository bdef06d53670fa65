#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (deepgemm_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed N]

Phases, one line each (a failure in any phase exits non-zero):
  1. the card: name and power limit as nvidia-smi prints them;
  2. the build: the four CUDA libraries with nvcc, in parallel, from csrc/;
  3. the dense FP8 kernel against its plain version at 4096^3 and
     128x4096x7168, then the library entry fp8_gemm_nt (launches counted);
  4. the masked grouped kernel, bf16 and fp8, against its plain version at
     the model's expert-GEMM shapes (G=256, max_m=40: 4096x7168 and
     7168x2048), with full and with seeded random masked_m (valid rows);
  5. the serving path: the MoE transformer forward at DeepSeek-V3 widths
     (hidden 7168, 128 heads, 256 experts, top-8, intermediate 2048, vocab
     129280; 2 layers of 61), bf16 and fp8, three [2, 64] token batches
     each: launch counts, tokens/s after the first batch, finite logits,
     each layer's kernel MoE output against the plain one on the same
     input, and the free-running kernel logits against the plain path's
     over the tokens no routing difference reached, held to the plain
     path's own distance from itself with reversed k sums (see walk); then
     one forward of each kind under torch.profiler: wall and device time,
     the device's idle share, and the device time by kernel. The plain path
     is the kernels' plain versions on the card (kernels.common.
     plain_versions);
  6. the training path: three FP8 SGD steps (lr 0.5) on one [2, 1024]
     batch at the same widths, 1 layer (capacity factor 1.99: 128 rows per
     expert): launches per step (dense 6, contiguous 4, k-grouped 2,
     masked 0), every kernel call of step 1 against its plain version on
     the step's own inputs (16 seeded experts of each grouped call, 256
     rows of each dense call), a finite loss that falls from step 1 to 3,
     seconds per step, tokens/s and peak memory; one more step under
     torch.profiler; then each call's kernel, plain version and bf16
     PyTorch yardstick timed at the step's full shapes.
Then one JSON line of kernel numbers, the card's nvidia-smi line, and the
last line {"ok": true, "device": {...}}.

Times come from CUDA events (deepgemm_tpu_torch/testing/bench.py). The
plain versions and the library yardsticks run f32 products with TF32 off.
bound_ms is the larger of the bytes each call must move (inputs read once,
output written once) over 3.35 TB/s and its operations over the H100's
dense peak for the operand type (989 TFLOP/s bf16, 1979 fp8).
"""

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import torch

TOL = 1e-5          # calc_diff limit: kernel against plain, logits against logits
# Free-running logits, kernel against plain, may be at most this many times
# as far apart as the plain path is from itself with reversed k sums.
FLOOR_FACTOR = 2.0


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(line):
    print(line, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def randn_bf16(shape, gen, scale):
    """bf16 N(0, scale^2) on the card, drawn one leading slice at a time."""
    out = torch.empty(shape, dtype=torch.bfloat16, device='cuda')
    for i in range(shape[0]):
        out[i] = (torch.randn(shape[1:], generator=gen, device='cuda') * scale).to(torch.bfloat16)
    return out


def numbers(ms, plain_ms, library_ms, max_abs_err, bound):
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                max_abs_err=max_abs_err, bound_ms=bound[0], bound_by=bound[1])


def summed(entries):
    """One kernel's numbers over its main-path shapes: times and bounds
    summed (the calls run one after another), the worst error."""
    total = {key: sum(e[key] for e in entries)
             for key in ('ms', 'plain_ms', 'library_ms', 'bound_ms')}
    total['max_abs_err'] = max(e['max_abs_err'] for e in entries)
    by = {}
    for e in entries:
        by[e['bound_by']] = by.get(e['bound_by'], 0.0) + e['bound_ms']
    total['bound_by'] = max(by, key=by.get)
    return total


def compare(d_kernel, d_plain, rows=None):
    """(calc_diff, max |kernel - plain|) over the valid rows."""
    from deepgemm_tpu_torch.testing import calc_diff
    k, p = d_kernel.float(), d_plain.float()
    if rows is not None:
        k, p = k[rows], p[rows]
    require(torch.isfinite(k).all().item(), 'kernel output is not finite')
    return calc_diff(k, p), (k - p).abs().max().item()


def phase_build():
    from deepgemm_tpu_torch.runtime import build
    t0 = time.perf_counter()
    reports = build.build()
    for name in build.SOURCES:
        build.load(name)
    seconds = time.perf_counter() - t0
    log(f'phase 2 build: {seconds:.2f} s for {list(build.SOURCES)} '
        f'(compiled now: {sorted(reports)})')
    for name, text in sorted(reports.items()):
        for line in text.splitlines():
            if any(word in line for word in ('entry function', 'registers', 'spill')):
                log(f'  ptxas {name}: {line.strip()}')


DENSE_SHAPES = ((4096, 4096, 4096), (128, 4096, 7168))    # bench.py:202-203


def phase_dense(gen, arch):
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.testing import calc_diff
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    entries = []
    for m, n, k in DENSE_SHAPES:
        a = randn_bf16((m, k), gen, 1.0)
        b = randn_bf16((n, k), gen, 1.0)
        aq, sfa = dgt.per_token_cast_to_fp8(a, use_ue8m0=False)
        bq, sfb = dgt.per_block_cast_to_fp8(b, use_ue8m0=False)
        kernel = lambda: dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb)
        plain = lambda: dense.dense_fp8_gemm_nt_plain(aq, bq, sfa, sfb)
        library = lambda: torch.matmul(a, b.t())
        d_k, d_p = kernel(), plain()
        torch.cuda.synchronize()
        diff, err = compare(d_k, d_p)
        require(diff < TOL, f'dense {m}x{n}x{k}: calc_diff {diff} against the plain version')
        quant = calc_diff(d_k, library())
        require(quant < 1e-3, f'dense {m}x{n}x{k}: calc_diff {quant} against bf16 a @ b.T')

        # the library entry a user calls: one counted launch
        dense.launches = 0
        d_api = dgt.fp8_gemm_nt((aq, sfa), (bq, sfb))
        torch.cuda.synchronize()
        require(dense.launches == 1, f'fp8_gemm_nt launched the dense kernel {dense.launches} times')
        require(torch.equal(d_api, d_k), 'fp8_gemm_nt differs from the kernel wrapper')

        ms = bench_kernel(kernel, iters=20)
        plain_ms = bench_kernel(plain, iters=3, warmup=1)
        library_ms = bench_kernel(library, iters=20)
        nbytes = sum(t.numel() * t.element_size() for t in (aq, bq, sfa, sfb)) + 2 * m * n
        bound = arch.bound_ms(nbytes, 2 * m * n * k, fp8=True)
        entries.append(dict(shape=[m, n, k], **numbers(ms, plain_ms, library_ms, err, bound)))
        log(f'phase 3 dense m={m} n={n} k={k}: calc_diff={diff:.3e} (limit {TOL}) '
            f'max_abs_err={err:.4g} vs_bf16_matmul={quant:.3e} kernel_ms={ms:.4f} '
            f'plain_ms={plain_ms:.4f} library_ms(torch.matmul bf16)={library_ms:.4f} '
            f'bound_ms={bound[0]:.4f} ({bound[1]}) TFLOPS={2 * m * n * k / ms / 1e9:.1f} '
            f'fp8_gemm_nt_launches=1')
        del a, b, aq, bq, d_k, d_p, d_api
    return entries


# The forward's expert GEMMs at DeepSeek-V3 widths: T=128 tokens, top-8 of
# 256 experts, capacity factor 8 -> 40 rows per expert.
MASKED_SHAPES = (('L1', 256, 40, 4096, 7168), ('L2', 256, 40, 7168, 2048))


def phase_masked(gen, arch):
    from deepgemm_tpu_torch.kernels import grouped
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8, quantize_experts
    entries = {'bf16': [], 'fp8': []}
    for label, g, max_m, n, k in MASKED_SHAPES:
        a = randn_bf16((g, max_m, k), gen, 1.0)
        b = randn_bf16((g, n, k), gen, k ** -0.5)
        full = torch.full((g,), max_m, dtype=torch.int32, device='cuda')
        rand_m = torch.randint(0, max_m + 1, (g,), generator=gen, device='cuda',
                               dtype=torch.int32)
        library_ms = bench_kernel(lambda: torch.bmm(a, b.transpose(1, 2)), iters=5)
        aq, asf = per_token_cast_to_fp8(a.view(-1, k), use_ue8m0=False)
        aq, asf = aq.view(g, max_m, k), asf.view(g, max_m, -1)
        bq, bsf = quantize_experts(b)
        cases = (('bf16', (a, b), {}), ('fp8', (aq, bq), dict(sfa=asf, sfb=bsf)))
        for kind, ops, kw in cases:
            d_p = grouped.masked_gemm_plain(*ops, full, **kw)
            checks = []
            for mm in (full, rand_m):
                d_k = grouped.masked_gemm(*ops, mm, **kw)
                torch.cuda.synchronize()
                rows = torch.arange(max_m, device='cuda')[None, :] < mm[:, None]
                diff, err = compare(d_k, d_p, rows)
                require(diff < TOL, f'masked {kind} {label}: calc_diff {diff} against the plain version')
                checks.append((diff, err))
            ms = bench_kernel(lambda: grouped.masked_gemm(*ops, full, **kw), iters=5)
            ms_random = bench_kernel(lambda: grouped.masked_gemm(*ops, rand_m, **kw), iters=5)
            plain_ms = bench_kernel(lambda: grouped.masked_gemm_plain(*ops, full, **kw),
                                    iters=2, warmup=1)
            nbytes = sum(t.numel() * t.element_size() for t in (*ops, *kw.values(), full))
            nbytes += 2 * g * max_m * n
            bound = arch.bound_ms(nbytes, 2 * g * max_m * n * k, fp8=kind == 'fp8')
            err = max(e for _, e in checks)
            entries[kind].append(dict(shape=[g, max_m, n, k], label=label,
                                      random_masked_ms=ms_random,
                                      **numbers(ms, plain_ms, library_ms, err, bound)))
            log(f'phase 4 masked {kind} {label} G={g} max_m={max_m} n={n} k={k}: '
                f'calc_diff full={checks[0][0]:.3e} random={checks[1][0]:.3e} (limit {TOL}, '
                f'valid rows; random live rows {int(rand_m.sum())}/{g * max_m}) '
                f'max_abs_err={err:.4g} kernel_ms={ms:.4f} random_masked_ms={ms_random:.4f} '
                f'plain_ms={plain_ms:.4f} library_ms(torch.bmm bf16)={library_ms:.4f} '
                f'bound_ms={bound[0]:.4f} ({bound[1]}) '
                f'GB/s={nbytes / ms / 1e6:.1f}')
            del d_p, d_k
        del a, b, aq, asf, bq, bsf
        torch.cuda.empty_cache()
    return entries


# DeepSeek-V3 widths (config.json of deepseek-ai/DeepSeek-V3); 2 of 61 layers.
V3 = dict(vocab=129280, hidden=7168, num_layers=2, num_heads=128, head_dim=128,
          num_experts=256, topk=8, moe_intermediate=2048, capacity_factor=8.0)
BATCHES, BATCH_SHAPE = 3, (2, 64)


@contextlib.contextmanager
def reversed_k_sums():
    """While open (inside plain_versions), the plain expert GEMMs run with
    the k axis of every operand and scale reversed: the same products summed
    in another order. That path is a second correct implementation; its
    distance from the plain path is the floor that the kernels' distance is
    held to."""
    from deepgemm_tpu_torch.kernels import grouped
    plain = grouped.masked_gemm_plain

    def flip(t):
        if t is None or t.dtype != torch.float8_e4m3fn:
            return None if t is None else t.flip(-1)
        return t.view(torch.uint8).flip(-1).view(t.dtype)   # no float8 flip

    def reversed_plain(a, b, masked_m, sfa=None, sfb=None, gran_n=128):
        require(a.shape[-1] % 128 == 0, 'k must be whole 128-deep scale blocks')
        return plain(flip(a), flip(b), masked_m, flip(sfa), flip(sfb), gran_n)

    grouped.masked_gemm_plain = reversed_plain
    try:
        yield
    finally:
        grouped.masked_gemm_plain = plain


def path_context(path):
    """The kernels for 'kernel'; their plain versions on the card for
    'plain'; the plain versions with reversed k sums for 'reversed'."""
    from deepgemm_tpu_torch.kernels.common import plain_versions
    stack = contextlib.ExitStack()
    if path != 'kernel':
        stack.enter_context(plain_versions())
    if path == 'reversed':
        stack.enter_context(reversed_k_sums())
    return stack


def walk(params, tokens, cfg):
    """Three forwards, each free-running, layer by layer: through the
    kernels, through the plain versions, and through the plain versions
    with reversed k sums (see path_context). Besides, each layer's plain MoE
    block runs on the kernel path's own input: the kernels' error in that
    layer alone.

    Routing is a top-k over router logits, then a per-expert capacity, so a
    last-bit difference can give a token other experts at a near tie, or
    drop another pair at a full expert. Per layer and for the kernel and
    reversed paths against the plain one: the (token, k) choices of the
    plain path not made, the tokens whose kept experts differ, the pairs
    dropped, the smallest router margin (k-th minus (k+1)-th logit, plain
    path) at a token whose choices differ, and the largest router-logit
    difference. ``reached`` marks the tokens a difference can touch: the
    token itself and, after any layer but the last, every later position of
    its sequence (attention). Returns (per-layer dicts, logits by path,
    reached by path)."""
    from deepgemm_tpu_torch.models.transformer import attention, moe_block, rms_norm
    from deepgemm_tpu_torch.parallel.moe import dispatch_indices, moe_capacity
    from deepgemm_tpu_torch.testing import calc_diff
    topk, experts, last = cfg.topk, cfg.num_experts, len(params['layers']) - 1
    cap = moe_capacity(tokens.numel(), topk, experts, cfg.capacity_factor)

    def kept_experts(router):
        idx = torch.topk(router, topk, dim=-1).indices
        kept = dispatch_indices(idx, experts, cap)[2].view(idx.shape)
        return idx, torch.zeros_like(router, dtype=torch.bool).scatter_(1, idx, kept)

    paths = ('kernel', 'plain', 'reversed')
    x = {p: params['embed'][tokens] for p in paths}
    reached = {p: torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
               for p in ('kernel', 'reversed')}
    layers = []
    for i, layer in enumerate(params['layers']):
        h, moe_in, router, y = {}, {}, {}, {}
        for p in paths:
            h[p] = x[p] + attention(rms_norm(x[p], layer['ln1']), layer['wqkv'], layer['wo'], cfg)
            moe_in[p] = rms_norm(h[p], layer['ln2'])
            router[p] = moe_in[p].reshape(-1, moe_in[p].shape[-1]).float() @ layer['router'].t()
            with path_context(p):
                y[p] = moe_block(moe_in[p], layer, cfg)
        with path_context('plain'):
            entry = dict(moe_diff=calc_diff(y['kernel'], moe_block(moe_in['kernel'], layer, cfg)))
        top_p = torch.topk(router['plain'], topk + 1, dim=-1)
        margin = top_p.values[:, topk - 1] - top_p.values[:, topk]
        kept_p = kept_experts(router['plain'])[1]
        entry.update(median_margin=margin.median().item(),
                     plain_dropped=topk * tokens.numel() - int(kept_p.sum()))
        for p in reached:
            idx, kept = kept_experts(router[p])
            missing = (top_p.indices[:, :topk, None] != idx[:, None, :]).all(-1).sum(-1)
            differs = (kept != kept_p).any(-1)
            entry[p] = dict(
                choices=int(missing.sum()), tokens=int(differs.sum()),
                dropped=topk * tokens.numel() - int(kept.sum()),
                min_margin=margin[missing > 0].min().item() if (missing > 0).any() else None,
                router_max_abs_diff=(router[p] - router['plain']).abs().max().item())
            reached[p] |= differs.view(tokens.shape)
            if i < last:
                reached[p] = reached[p].cumsum(dim=-1) > 0
        layers.append(entry)
        x = {p: h[p] + y[p] for p in paths}
    embed = params['embed'].float()
    logits = {p: torch.matmul(rms_norm(x[p], params['final_norm']).float(), embed.t())
              for p in paths}
    return layers, logits, reached


def profile(fn, label, what):
    """One call of ``fn`` under torch.profiler: its wall time, the time of
    the device's own events (kernels, copies, sets) summed, and the names
    that take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    if not by_name:
        log(f'profile {label}: wall_ms={wall_ms:.3f}; the profiler saw no device '
            f'events, device time not measured')
        return
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    log(f'profile {label}: wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} '
        f'device_idle_share={1 - device_ms / wall_ms:.4f} ({what}, under the profiler)')
    for name, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f'  {us / 1e3:10.3f} ms device, {calls:6d} calls: {name[:130]}')


def phase_forward(seed):
    """Checks, for each kind: the kernel path's logits are finite and of
    the right shape; each layer's kernel MoE output against the plain one on
    the same input at calc_diff < TOL; and the free-running kernel logits
    against the plain ones, over the tokens no routing difference reached,
    at most FLOOR_FACTOR times the same distance of the reversed-k plain
    path (or TOL, if that is larger), the worst batch against the worst.
    The routing differences, their router margins and the drops are
    printed."""
    from deepgemm_tpu_torch.kernels import dense, grouped
    from deepgemm_tpu_torch.models.transformer import ModelConfig, forward, init_params
    from deepgemm_tpu_torch.testing import calc_diff
    t0 = time.perf_counter()
    params = init_params(ModelConfig(**V3), seed=seed, device='cuda')
    torch.cuda.synchronize()
    log(f'phase 5 init: {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 1e9:.2f} GB of weights on the card')
    gen = torch.Generator(device='cuda').manual_seed(seed + 1)
    batches = [torch.randint(0, V3['vocab'], BATCH_SHAPE, generator=gen, device='cuda')
               for _ in range(BATCHES)]
    counts = {}
    for use_fp8 in (False, True):
        kind, other = ('fp8', 'bf16') if use_fp8 else ('bf16', 'fp8')
        cfg_kernel = ModelConfig(**V3, use_fp8=use_fp8, use_kernels=True)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        # the main path: counts at 0 just before, read just after
        dense.launches = 0
        grouped.launches.update(bf16=0, fp8=0)
        logits, seconds = [], []
        for tokens in batches:
            t0 = time.perf_counter()
            logits.append(forward(params, tokens, cfg_kernel))
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        seen = dict(grouped.launches, dense=dense.launches)
        expected = 2 * V3['num_layers'] * BATCHES
        require(seen[kind] == expected and seen[other] == 0 and seen['dense'] == 0,
                f'forward {kind}: launches {seen}, expected {expected} {kind} masked launches')
        counts[kind] = seen[kind]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        lines, free, floor = [], [], []
        fmt = lambda v: 'none' if v is None else f'{v:.3e}'
        for tokens, lk in zip(batches, logits):
            require(tuple(lk.shape) == (*BATCH_SHAPE, V3['vocab']), f'logits shape {tuple(lk.shape)}')
            require(torch.isfinite(lk).all().item(), f'forward {kind}: logits not finite')
            layers, walked, reached = walk(params, tokens, cfg_kernel)
            again = calc_diff(lk, walked['kernel'])
            moe_diffs = [layer['moe_diff'] for layer in layers]
            require(max(moe_diffs) < TOL and again < TOL,
                    f'forward {kind}: moe {moe_diffs}, kernel again {again} (limit {TOL})')
            unreached = {}
            for p, mask in reached.items():
                clean = ~mask
                unreached[p] = (calc_diff(walked[p][clean], walked['plain'][clean])
                                if clean.any() else None, int(clean.sum()))
            free.append(unreached['kernel'][0])
            floor.append(unreached['reversed'][0])
            routing = '; '.join(
                f'L{i} {p}: {e[p]["choices"]} choices at {e[p]["tokens"]} tokens, '
                f'dropped {e[p]["dropped"]} (plain {e["plain_dropped"]}), '
                f'min_margin={fmt(e[p]["min_margin"])} '
                f'router_max_abs_diff={e[p]["router_max_abs_diff"]:.3e}'
                for i, e in enumerate(layers) for p in reached)
            margins = [f'{e["median_margin"]:.3e}' for e in layers]
            lines.append(
                f'moe_layers={[f"{d:.3e}" for d in moe_diffs]} '
                f'all_tokens: kernel={calc_diff(lk, walked["plain"]):.3e} '
                f'reversed={calc_diff(walked["reversed"], walked["plain"]):.3e}; '
                + ' '.join(f'unreached {p}={fmt(d)} ({n}/{lk.shape[0] * lk.shape[1]})'
                           for p, (d, n) in unreached.items())
                + f' | median_margins={margins} ' + routing)
        worst = max((d for d in free if d is not None), default=0.0)
        worst_floor = max((d for d in floor if d is not None), default=0.0)
        limit = max(TOL, FLOOR_FACTOR * worst_floor)
        torch.cuda.synchronize()
        tokens_per_s = (BATCHES - 1) * BATCH_SHAPE[0] * BATCH_SHAPE[1] / sum(seconds[1:])
        log(f'phase 5 forward {kind}: launches={seen} tokens/s={tokens_per_s:.1f} '
            f'(batches 2-{BATCHES} of {BATCH_SHAPE}; seconds per batch '
            f'{[round(s, 4) for s in seconds]}, the first with warm-up'
            f'{", fp8 weight quantization in every call" if use_fp8 else ""}) '
            f'peak_mem={peak_gb:.2f} GB')
        for i, line in enumerate(lines):
            log(f'  batch {i} calc_diff vs plain: {line}')
        log(f'phase 5 free-running {kind}: worst unreached calc_diff kernel vs plain '
            f'{worst:.3e}, limit {limit:.3e} (max of {TOL} and {FLOOR_FACTOR} x the '
            f'reversed-k plain path\'s worst {worst_floor:.3e})')
        require(worst <= limit, f'forward {kind}: free-running logits {free} against '
                f'the plain path, above {limit} (reversed-k floor {floor})')
        del logits
        profile(lambda: forward(params, batches[0], cfg_kernel), f'forward {kind}',
                f'one [2, 64] batch')
    del params
    torch.cuda.empty_cache()
    return counts


# Phase 6: the FP8 training step at DeepSeek-V3 widths, 1 layer (one whole
# period: the flagship has no dense layers), [2, 1024] tokens. Capacity
# factor 1.99 gives cap = align(int(64 * 1.99) + 1, 8) = 128 rows per expert,
# the 128-row groups the wgrad's per-channel scales need: 32768 rows.
V3_TRAIN = dict(V3, num_layers=1, capacity_factor=1.99)
TRAIN_SHAPE, TRAIN_STEPS, TRAIN_LR = (2, 1024), 3, 0.5
CHECK_EXPERTS = 16      # experts whose rows and dw hold each grouped kernel to its plain version
CHECK_ROWS = 256        # rows of A that hold each dense call to its plain version
PER_STEP = dict(dense=6, contiguous=4, k_grouped=2, masked=0)
# the kernel calls of one step, in the order the step makes them
CALL_NAMES = dict(
    dense=('qkv fwd', 'o fwd', 'o dgrad', 'o wgrad', 'qkv dgrad', 'qkv wgrad'),
    contiguous=('L1 fwd', 'L2 fwd', 'L2 dgrad', 'L1 dgrad'),
    k_grouped=('L2 wgrad', 'L1 wgrad'))


@contextlib.contextmanager
def capture_calls(records, seed):
    """While open, every dense, contiguous and k-grouped kernel call that
    the ops make is recorded: its shapes, and a seeded subset of its inputs
    and of the kernel's output, for holding the kernel against its plain
    version on the step's own inputs. The grouped ops keep CHECK_EXPERTS
    experts (their rows and dw[e] are exactly the full op's: every cast and
    product in them is per expert), the dense op CHECK_ROWS rows of A. The
    wrappers are called as they are, once each: the counts see one launch."""
    from deepgemm_tpu_torch.kernels.common import select_rows as take
    from deepgemm_tpu_torch.ops import gemm, k_grouped as kg_ops, m_grouped
    gen = torch.Generator().manual_seed(seed)

    def pick(count, keep):
        return torch.randperm(count, generator=gen)[:keep].sort().values.cuda()

    def dense_call(args, kw, out):
        a, b, sfa, sfb = args
        rows = pick(a.shape[0], CHECK_ROWS)
        return dict(kind='dense', shape=(a.shape[0], b.shape[0], a.shape[1]),
                    gran_n=kw['gran_n'], out_dtype=kw['out_dtype'],
                    inputs=(take(a, rows), b, take(sfa, rows), sfb), out=take(out, rows))

    def contiguous_call(args, kw, out):
        a, b, ids = args
        require(not kw['use_psum_layout'] and 'sfa' in kw, 'the step uses fp8 and per-row ids')
        experts = pick(b.shape[0], CHECK_EXPERTS).int()
        rows = torch.isin(ids, experts).nonzero().squeeze(1)
        sub_ids = torch.searchsorted(experts, ids[rows].contiguous()).int()
        return dict(kind='contiguous', shape=(a.shape[0], b.shape[1], a.shape[1], b.shape[0]),
                    gran_n=kw['gran_n'],
                    inputs=(take(a, rows), take(b, experts.long()), sub_ids,
                            take(kw['sfa'], rows), take(kw['sfb'], experts.long())),
                    out=take(out, rows))

    def k_grouped_call(args, kw, out):
        a, b, sizes, c, sfa, sfb = args
        require(c is None and not kw['use_psum_layout'], 'the step passes depths and no c')
        experts = pick(sizes.numel(), CHECK_EXPERTS)
        size = sizes.tolist()
        start = [sum(size[:e]) for e in range(len(size))]
        sf_count = [-(-z // 128) for z in size]
        sf_start = [sum(sf_count[:e]) for e in range(len(size))]
        ks = [torch.arange(start[e], start[e] + size[e]) for e in experts.tolist()]
        sf = [torch.arange(sf_start[e], sf_start[e] + sf_count[e]) for e in experts.tolist()]
        rows, sf_rows = torch.cat(ks).cuda(), torch.cat(sf).cuda()
        return dict(kind='k_grouped', shape=(a.shape[1], b.shape[1], a.shape[0], sizes.numel()),
                    out_dtype=kw['out_dtype'],
                    inputs=(take(a, rows), take(b, rows), sizes[experts].contiguous(),
                            take(sfa, sf_rows), take(sfb, sf_rows)),
                    out=take(out, experts))

    hooks = ((gemm, 'dense_fp8_gemm_nt', dense_call),
             (m_grouped, 'contiguous_gemm', contiguous_call),
             (kg_ops, 'k_grouped_gemm', k_grouped_call))
    originals = [(module, name, getattr(module, name)) for module, name, _ in hooks]

    def recording(fn, record):
        def call(*args, **kw):
            out = fn(*args, **kw)
            records.append(record(args, kw, out))
            return out
        return call

    for (module, name, record), (_, _, fn) in zip(hooks, originals):
        setattr(module, name, recording(fn, record))
    try:
        yield
    finally:
        for module, name, fn in originals:
            setattr(module, name, fn)


def check_captured(records):
    """Each recorded call's kernel output against its plain version on the
    same inputs; the records are emptied on the way. Returns {kind: [the
    call's name, shapes, calc_diff and max_abs_err, ...]}."""
    from deepgemm_tpu_torch.kernels import dense, grouped, k_grouped
    seen = {kind: 0 for kind in CALL_NAMES}
    results = {kind: [] for kind in CALL_NAMES}
    for rec in records:
        kind = rec['kind']
        name = CALL_NAMES[kind][seen[kind]]
        seen[kind] += 1
        a, b, *rest = rec['inputs']
        if kind == 'dense':
            ref = dense.dense_fp8_gemm_nt_plain(a, b, *rest, gran_n=rec['gran_n'],
                                                out_dtype=rec['out_dtype'])
        elif kind == 'contiguous':
            ids, sfa, sfb = rest
            ref = grouped.contiguous_gemm_plain(a, b, ids, sfa, sfb, gran_n=rec['gran_n'])
        else:
            sizes, sfa, sfb = rest
            ref = k_grouped.k_grouped_gemm_plain(a, b, sizes, None, sfa, sfb,
                                                 out_dtype=rec['out_dtype'])
        torch.cuda.synchronize()
        diff, err = compare(rec['out'], ref)
        require(diff < TOL, f'train {kind} {name} {rec["shape"]}: calc_diff {diff} '
                f'against the plain version')
        meta = {key: rec[key] for key in ('shape', 'gran_n', 'out_dtype') if key in rec}
        results[kind].append(dict(meta, name=name, diff=diff, err=err))
        log(f'phase 6 check {kind} {name} shape={rec["shape"]}: calc_diff={diff:.3e} '
            f'(limit {TOL}) max_abs_err={err:.4g} on {tuple(rec["out"].shape)} of the output')
        del ref
    records.clear()
    require(seen == {kind: PER_STEP[kind] for kind in CALL_NAMES},
            f'step 1 made the kernel calls {seen}')
    return results


def time_train_kernels(results, gen, arch):
    """Each kernel call of the step, timed at its full shapes on seeded
    inputs of the step's kinds (the kernel, its plain version, one bf16
    PyTorch call on the same shapes), with its bound. Returns per-kind
    lists of number dicts."""
    from deepgemm_tpu_torch.kernels import dense, grouped, k_grouped
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import (per_block_cast_to_fp8, per_channel_cast_to_fp8,
                                               per_token_cast_to_fp8, quantize_experts)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    entries = {kind: [] for kind in CALL_NAMES}
    for kind, calls in results.items():
        for rec in calls:
            name, err = rec['name'], rec['err']
            if kind == 'dense':
                m, n, k = rec['shape']
                a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
                aq, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
                bq, sfb = (per_token_cast_to_fp8(b, use_ue8m0=False) if rec['gran_n'] == 1
                           else per_block_cast_to_fp8(b, use_ue8m0=False))
                args = (aq, bq, sfa, sfb)
                kw = dict(gran_n=rec['gran_n'], out_dtype=rec['out_dtype'])
                kernel = lambda: dense.dense_fp8_gemm_nt(*args, **kw)
                plain = lambda: dense.dense_fp8_gemm_nt_plain(*args, **kw)
                library = lambda: torch.matmul(a, b.t())
                out_bytes = m * n * (4 if rec['out_dtype'] == torch.float32 else 2)
                flops, inputs = 2 * m * n * k, args
            elif kind == 'contiguous':
                m, n, k, g = rec['shape']
                a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((g, n, k), gen, k ** -0.5)
                aq, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
                bq, sfb = quantize_experts(b)
                ids = torch.arange(g, dtype=torch.int32, device='cuda').repeat_interleave(m // g)
                args, kw = (aq, bq, ids), dict(sfa=sfa, sfb=sfb)
                kernel = lambda: grouped.contiguous_gemm(*args, **kw)
                plain = lambda: grouped.contiguous_gemm_plain(*args, **kw)
                library = lambda: torch.bmm(a.view(g, m // g, k), b.transpose(1, 2))
                out_bytes, flops, inputs = 2 * m * n, 2 * m * n * k, (aq, bq, sfa, sfb, ids)
            else:
                m, n, total_k, g = rec['shape']
                a, b = randn_bf16((total_k, m), gen, 1.0), randn_bf16((total_k, n), gen, 1.0)
                (aq, sfa), (bq, sfb) = (per_channel_cast_to_fp8(x, use_ue8m0=False) for x in (a, b))
                sizes = torch.full((g,), total_k // g, dtype=torch.int32, device='cuda')
                args, kw = (aq, bq, sizes, None, sfa, sfb), dict(out_dtype=rec['out_dtype'])
                kernel = lambda: k_grouped.k_grouped_gemm(*args, **kw)
                plain = lambda: k_grouped.k_grouped_gemm_plain(*args, **kw)
                library = lambda: torch.bmm(a.view(g, -1, m).transpose(1, 2), b.view(g, -1, n))
                out_bytes = g * m * n * (4 if rec['out_dtype'] == torch.float32 else 2)
                flops, inputs = 2 * m * n * total_k, (aq, bq, sfa, sfb, sizes)
            ms = bench_kernel(kernel, iters=5)
            plain_ms = bench_kernel(plain, iters=1, warmup=1)
            library_ms = bench_kernel(library, iters=5)
            bound = arch.bound_ms(nbytes(*inputs) + out_bytes, flops, fp8=True)
            entries[kind].append(dict(name=name, shape=list(rec['shape']), check_calc_diff=rec['diff'],
                                      **numbers(ms, plain_ms, library_ms, err, bound)))
            log(f'phase 6 time {kind} {name} shape={rec["shape"]}: kernel_ms={ms:.4f} '
                f'plain_ms={plain_ms:.4f} library_ms(bf16 torch.{"matmul" if kind == "dense" else "bmm"})='
                f'{library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) '
                f'GB/s={(nbytes(*inputs) + out_bytes) / ms / 1e6:.1f} '
                f'TFLOPS={flops / ms / 1e9:.1f}')
            del a, b, args, inputs, kernel, plain, library
            torch.cuda.empty_cache()
    return entries


def phase_train(seed, arch):
    """Three FP8 SGD steps on one [2, 1024] batch at V3 widths through the
    training path's kernels. Checks: the launches per step (dense 6,
    contiguous 4, k-grouped 2, masked 0), each kernel call of step 1 against
    its plain version on the step's own inputs (calc_diff < TOL), a finite
    loss that falls from step 1 to step 3. Prints the step time, tokens/s,
    peak memory, a profile of one more step; then times each kernel call at
    its full shapes. Returns (per-kind timing entries, launches)."""
    from deepgemm_tpu_torch.kernels import dense, grouped, k_grouped
    from deepgemm_tpu_torch.models.transformer import ModelConfig, init_params, train_step
    cfg = ModelConfig(**V3_TRAIN, use_fp8=True, use_kernels=True, use_fp8_training=True)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed + 2, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(seed + 3)
    tokens, targets = (torch.randint(0, cfg.vocab, TRAIN_SHAPE, generator=gen, device='cuda')
                       for _ in range(2))
    torch.cuda.synchronize()
    log(f'phase 6 init: {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 1e9:.2f} GB of weights on the card '
        f'(1 layer, {TRAIN_SHAPE} tokens, lr {TRAIN_LR}, SGD)')

    def counts():
        return dict(dense=dense.launches, contiguous=grouped.contiguous_launches['fp8'],
                    k_grouped=k_grouped.launches['fp8'],
                    masked=sum(grouped.launches.values()),
                    bf16=grouped.contiguous_launches['bf16'] + k_grouped.launches['bf16'])

    # the main path: counts at 0 just before, read just after the steps
    dense.launches = 0
    grouped.launches.update(bf16=0, fp8=0)
    grouped.contiguous_launches.update(bf16=0, fp8=0)
    k_grouped.launches.update(bf16=0, fp8=0)
    torch.cuda.reset_peak_memory_stats()
    losses, seconds, records = [], [], []
    for step in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        with capture_calls(records, seed) if step == 0 else contextlib.nullcontext():
            loss, params = train_step(params, tokens, targets, cfg, lr=TRAIN_LR)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.item())
        if step == 0:
            peak_capture_gb = torch.cuda.max_memory_allocated() / 1e9
            results = check_captured(records)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    seen = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {kind: TRAIN_STEPS * n for kind, n in PER_STEP.items()}
    require(seen == dict(want, bf16=0), f'train: launches {seen}, expected {want} and no bf16')
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f'train: losses {losses} are not finite and falling')
    tokens_per_s = (TRAIN_STEPS - 1) * tokens.numel() / sum(seconds[1:])
    log(f'phase 6 train: launches={seen} (per step {PER_STEP}) losses={losses} '
        f'seconds per step {[round(v, 4) for v in seconds]} (the first with warm-up and '
        f'the recording of its kernel calls) tokens/s={tokens_per_s:.1f} '
        f'peak_mem={peak_gb:.2f} GB (steps 2-{TRAIN_STEPS}; step 1 with its recordings '
        f'{peak_capture_gb:.2f} GB)')
    profile(lambda: train_step(params, tokens, targets, cfg, lr=TRAIN_LR), 'train step',
            f'one {TRAIN_SHAPE} step after {TRAIN_STEPS}')
    del params
    torch.cuda.empty_cache()
    entries = time_train_kernels(results, gen, arch)
    return entries, {kind: seen[kind] for kind in CALL_NAMES}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import deepgemm_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f'chip_smoke: deepgemm_tpu_torch is not beside this script: {exc}',
              file=sys.stderr)
        return 1
    from deepgemm_tpu_torch.heuristics.arch import H100_SXM

    # the plain versions and yardsticks take f32 products in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f'phase 1 card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda}, '
        f'{torch.cuda.get_device_name(0)})')
    phase_build()
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    dense_entries = phase_dense(gen, H100_SXM)
    torch.cuda.synchronize()
    masked = phase_masked(gen, H100_SXM)
    torch.cuda.synchronize()
    counts = phase_forward(args.seed)
    torch.cuda.synchronize()
    train, train_counts = phase_train(args.seed, H100_SXM)
    torch.cuda.synchronize()

    # Each kernel's numbers are those of the path that runs it: the masked
    # kernels the serving forward (phase 5), the others the training step
    # (phase 6), summed over its calls of one step; launches are the path's
    # own count. The dense kernel's phase 3 shapes are listed beside.
    def kernel(name, source, replaces, launches, entries, **extra):
        return dict(name=name, route='cuda', source=f'deepgemm_tpu_torch/csrc/{source}',
                    replaces=replaces, launches=launches, **summed(entries),
                    shapes=entries, **extra)

    kernels = [
        kernel('dense_fp8_gemm_nt', 'dense.cu', 'deepgemm_tpu/kernels/dense.py:291',
               train_counts['dense'], train['dense'], phase3_shapes=dense_entries),
        *(kernel(f'masked_grouped_gemm_{kind}', 'masked.cu',
                 'deepgemm_tpu/kernels/grouped.py:576', counts[kind], masked[kind])
          for kind in ('bf16', 'fp8')),
        kernel('contiguous_grouped_gemm_fp8', 'contiguous.cu',
               'deepgemm_tpu/kernels/grouped.py:240', train_counts['contiguous'],
               train['contiguous']),
        kernel('k_grouped_gemm_fp8', 'k_grouped.cu', 'deepgemm_tpu/kernels/k_grouped.py:237',
               train_counts['k_grouped'], train['k_grouped']),
    ]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
