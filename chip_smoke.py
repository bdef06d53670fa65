#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (deepgemm_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed N]

Phases, one line each (a failure in any phase exits non-zero):
  1. the card: name and power limit as nvidia-smi prints them;
  2. the build: both CUDA libraries with nvcc, in parallel, from csrc/;
  3. the dense FP8 kernel against its plain version at 4096^3 and
     128x4096x7168, then the library entry fp8_gemm_nt (launches counted);
  4. the masked grouped kernel, bf16 and fp8, against its plain version at
     the model's expert-GEMM shapes (G=256, max_m=40: 4096x7168 and
     7168x2048), with full and with seeded random masked_m (valid rows);
  5. the MoE transformer forward at DeepSeek-V3 widths (hidden 7168, 128
     heads, 256 experts, top-8, intermediate 2048, vocab 129280; 2 layers
     of 61), bf16 and fp8, three [2, 64] token batches each: launch counts,
     tokens/s after the first batch, finite logits, each layer's kernel MoE
     output against the plain one on the same input, and the free-running
     kernel logits against the plain path's over the tokens no routing
     difference reached, held to the plain path's own distance from itself
     with reversed k sums (see walk); then one forward of each kind under
     torch.profiler: wall and device time, the device's idle share, and the
     device time by kernel.
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
    entries, launches = [], 0
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
        launches += dense.launches
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
    return dict(name='dense_fp8_gemm_nt', route='cuda',
                source='deepgemm_tpu_torch/csrc/dense.cu',
                replaces='deepgemm_tpu/kernels/dense.py:291',
                launches=launches, **summed(entries), shapes=entries)


# The forward's expert GEMMs at DeepSeek-V3 widths: T=128 tokens, top-8 of
# 256 experts, capacity factor 8 -> 40 rows per expert.
MASKED_SHAPES = (('L1', 256, 40, 4096, 7168), ('L2', 256, 40, 7168, 2048))


def phase_masked(gen, arch):
    from deepgemm_tpu_torch.kernels import grouped
    from deepgemm_tpu_torch.models.transformer import quantize_experts
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8
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
    """While open, the plain expert GEMMs run with the k axis of every
    operand and scale reversed: the same products summed in another order.
    That path is a second correct implementation; its distance from the
    plain path is the floor that the kernels' distance is held to."""
    from deepgemm_tpu_torch.parallel import moe
    plain = moe.masked_gemm_plain

    def flip(t):
        if t is None or t.dtype != torch.float8_e4m3fn:
            return None if t is None else t.flip(-1)
        return t.view(torch.uint8).flip(-1).view(t.dtype)   # no float8 flip

    def reversed_plain(a, b, masked_m, sfa=None, sfb=None, gran_n=128):
        require(a.shape[-1] % 128 == 0, 'k must be whole 128-deep scale blocks')
        return plain(flip(a), flip(b), masked_m, flip(sfa), flip(sfb), gran_n)

    moe.masked_gemm_plain = reversed_plain
    try:
        yield
    finally:
        moe.masked_gemm_plain = plain


def walk(params, tokens, cfg_kernel, cfg_plain):
    """Three forwards, each free-running, layer by layer: through the
    kernels, through the plain versions, and through the plain versions
    with reversed k sums. Besides, each layer's plain MoE block runs on the
    kernel path's own input: the kernels' error in that layer alone.

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
    topk, experts, last = cfg_kernel.topk, cfg_kernel.num_experts, len(params['layers']) - 1
    cap = moe_capacity(tokens.numel(), topk, experts, cfg_kernel.capacity_factor)

    def kept_experts(router):
        idx = torch.topk(router, topk, dim=-1).indices
        kept = dispatch_indices(idx, experts, cap)[2].view(idx.shape)
        return idx, torch.zeros_like(router, dtype=torch.bool).scatter_(1, idx, kept)

    paths = {'kernel': cfg_kernel, 'plain': cfg_plain, 'reversed': cfg_plain}
    x = {p: params['embed'][tokens] for p in paths}
    reached = {p: torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
               for p in ('kernel', 'reversed')}
    layers = []
    for i, layer in enumerate(params['layers']):
        h, moe_in, router, y = {}, {}, {}, {}
        for p, cfg in paths.items():
            h[p] = x[p] + attention(rms_norm(x[p], layer['ln1']), layer['wqkv'], layer['wo'], cfg)
            moe_in[p] = rms_norm(h[p], layer['ln2'])
            router[p] = moe_in[p].reshape(-1, moe_in[p].shape[-1]).float() @ layer['router'].t()
            with reversed_k_sums() if p == 'reversed' else contextlib.nullcontext():
                y[p] = moe_block(moe_in[p], layer, cfg)
        entry = dict(moe_diff=calc_diff(y['kernel'], moe_block(moe_in['kernel'], layer, cfg_plain)))
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


def profile_forward(params, tokens, cfg, kind):
    """One forward under torch.profiler: its wall time, the time of the
    device's own events (kernels, copies, sets) summed, and the names that
    take the most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from deepgemm_tpu_torch.models.transformer import forward
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(params, tokens, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    if not by_name:
        log(f'profile forward {kind}: wall_ms={wall_ms:.3f}; the profiler saw no device '
            f'events, device time not measured')
        return
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    log(f'profile forward {kind}: wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} '
        f'device_idle_share={1 - device_ms / wall_ms:.4f} (one [2, 64] batch, under the profiler)')
    for name, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f'  {us / 1e3:10.3f} ms device, {calls:6d} calls: {name[:110]}')


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
        cfg_plain = ModelConfig(**V3, use_fp8=use_fp8, use_kernels=False)
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
            layers, walked, reached = walk(params, tokens, cfg_kernel, cfg_plain)
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
        profile_forward(params, batches[0], cfg_kernel, kind)
    del params
    torch.cuda.empty_cache()
    return counts


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
    dense_entry = phase_dense(gen, H100_SXM)
    torch.cuda.synchronize()
    masked = phase_masked(gen, H100_SXM)
    torch.cuda.synchronize()
    counts = phase_forward(args.seed)
    torch.cuda.synchronize()

    kernels = [dense_entry] + [
        dict(name=f'masked_grouped_gemm_{kind}', route='cuda',
             source='deepgemm_tpu_torch/csrc/masked.cu',
             replaces='deepgemm_tpu/kernels/grouped.py:576',
             launches=counts[kind], **summed(masked[kind]), shapes=masked[kind])
        for kind in ('bf16', 'fp8')]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
