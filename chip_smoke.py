#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (deepgemm_tpu_torch) on one NVIDIA H100 and check it.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --gemm-times [--package-root DIR]
    python3 chip_smoke.py --mqa-times [--package-root DIR]
    python3 chip_smoke.py --ep-times [--package-root DIR]
    python3 chip_smoke.py --variants
    python3 chip_smoke.py --mqa-variants
    python3 chip_smoke.py --widen-variants
    python3 chip_smoke.py --masked-variants

The second form builds and times only phase 3, the training step's
dense, contiguous and k-grouped calls, the MQA logits kernel's calls
(phase 7's three and the bench shape's register-A instance), the paged MQA
entries at the decode shape (the e4m3 instance and the three bf16
instances of the FP4 pairs: each call as testing/bench.py times it, its
device time with the host work hidden, its host time and the part of that
outside the C entry), phase 10's dense forms on
bf16 products ('dequant' at both recipes, FP4 B at gran 32) and planar FP4
B at m 4096, and the masked kernel's calls (phase 4's decode L1 and L2,
fp8 and bf16; phase 9's fp8_einsum and its f32 instance; no plain
versions) of the deepgemm_tpu_torch under DIR, and prints them as one JSON
line; --mqa-times only its MQA logits and paged MQA calls. The timing
helpers are testing/bench.py's of that package: to time a tree that lacks
bench_kernel's hide_host, copy this tree's testing/bench.py into it. The
third runs only phase 11's
main path (the 8-rank forward: launches, tokens/s, peak memory, a profile
with the device's idle share) and #12 alone at V3's L1. Run either for two trees in one call
(parent, change, change, parent) to compare them. The fourth times the
contiguous grouped kernel against copies of itself built with a part
removed (the A loads, the B loads, the MMA, the stores, the NN form's
transpose) and with its ring held at 3, 4 or as many stages as fit, all in
turns in one process: what bounds it. The fifth does the same for the MQA
logits kernel's e4m3 calls of phase 7 (without the wgmma, without the head
sum, with neither the head sum nor the stores, and with only the pipeline's
barriers and loop left), then for the paged gather entry's decode call (its
device time with the host's work hidden: on e4m3 wgmma in place of the
exact widened products, the same parts removed, the pipeline with its
loads alone, and the run chooser aiming at 2, 8 and 16 items an SM in
place of 4). The sixth does the same for the dense forms on
bf16 products ('dequant' at both recipes and the FP4 gran 32 kernel, at
4096 x 4096 x 7168: without B's widening, without A's widening math,
without the wgmma). The seventh does the same for the masked kernel's
decode calls and fp8_einsum's call and for the fused dispatch + L1 at
phase 11's shape (at each ring cap, and without the wgmma).

Phases, one line each (a failure in any phase exits non-zero):
  1. the card: name and power limit as nvidia-smi prints them;
  2. the build: the twelve CUDA libraries with nvcc, in parallel, from csrc/,
     and the ptxas report (registers, shared memory, spills) of the Hopper
     mainloop's instances (csrc/gemm_sm90.cuh: the dense, k-grouped,
     contiguous and masked kernels and the fused dispatch + L1), each
     library's count and spills on a line, the dense forms on bf16 products
     (widen_kernel, dense_dequant) and the masked and dispatch instances
     (the same body, widen_body), each named with its registers and spills,
     then the MQA logits kernel's wgmma
     instances (csrc/mqa_sm90.cuh: the prefill entry's, Source::kLinear,
     and the paged entries', Source::kPaged), each named with its
     registers and spills (none may spill);
  3. the dense FP8 kernel (the Hopper mainloop) against its plain version at
     4096^3 and 128x4096x7168, then the library entry fp8_gemm_nt (launches
     counted, bitwise the wrapper's launch);
  4. the masked grouped kernel (the Hopper mainloop), bf16 and fp8, against its plain version at
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
     masked 0, the k-grouped relayout 4; the contiguous calls through the
     wgmma body's e4m3 NT form on 128-row tiles), every kernel call of step 1
     against its plain version on
     the step's own inputs (16 seeded experts of each grouped call, 256
     rows of each dense call), a finite loss that falls from step 1 to 3,
     seconds per step, tokens/s and peak memory; one more step under
     torch.profiler; then each call's kernel, plain version and bf16
     PyTorch yardstick timed at the step's full shapes, and each k-grouped
     call's relayout on its own (bitwise its plain version, beside
     x.t().contiguous()) with its share of the call;
  7. the serving engine over the lightning indexer: 64 slots, the indexer
     at DeepSeek-V3.2-Exp widths (64 heads x 128, top-2048, e4m3 pages of 64
     tokens), attention streams of 128 heads x 128 bf16; 64 prompts of
     4096-7936 tokens prefilled, 8 decode steps, one request finished and a
     new one (6000 tokens) admitted before step 4: launches per step (paged
     MQA 1, attention 1, MQA logits 0; the paged MQA instance that launched
     named beside its ptxas report), step 1's paged MQA call and 8 rows of
     its attention against their plain versions, the zero-copy entry on step
     1's cache (its own path) bitwise equal to the gather entry, the compute
     step twice bitwise equal, the same script through the plain versions
     (outputs compared where the top-k selections agree; how many (request,
     step) selections differ printed), two requests alone
     in a fresh engine bitwise equal (batch invariance); step times,
     tokens/s, peak memory, a profile of one step, each kernel timed at its
     full shape; then the same script under DGT_SPARSE_GATHER=pallas in a
     fresh engine: launches per step gather-fused attention 1, attention 0,
     paged MQA 1, MQA logits 0, every output bitwise equal to the flat
     run's, step times, tokens/s and peak memory beside the flat run's, the
     compute step twice bitwise equal, a profile of one step (the flat
     gather's index_select copies gone), the gather-fused kernel at full
     shape on step 1's selection (against its plain version on 8 seeded
     rows, bitwise equal to index_select + the gathered kernel on all 64,
     timed beside its bound, its plain version, the flat path and the
     gather + SDPA yardstick), the FP4 paged pairs on step 1's shapes (FP4
     q with an FP4 byte cache, FP4 q with the e4m3 cache, e4m3 q with the
     FP4 cache: the bf16 instances against their plain versions, the
     strategies bitwise equal, each timed beside the e4m3 instance), varlen
     pairing of 64 sequences of 1-8 tokens (host and device forms bitwise
     equal to each other and to the padded 2-D call) and the schedule
     metadata for the step's context lengths, then batch invariance in a
     fresh engine; then the prefill path (indexer_sparse_attention on the
     last 64 rows of an 8192-token prompt: MQA logits 1, attention 1, each
     held to its plain version, the MQA logits instance that launched named
     beside its ptxas report) and the MQA logits kernel at the JAX bench's
     prefill shape (2048 x 8192, 64 heads x 128) against its plain version,
     e4m3 and with FP4 q and kv (the bf16 instance), each of the three calls
     timed beside its bound and torch.matmul.
  8. the mega MoE forward: the model at the phase 5 widths (2 layers) with
     use_mega and the fused comm on three [2, 64] batches, with bf16 act
     and with DGT_MEGA_ACT_FP8=1: launches per forward (mega 1 a layer,
     masked 0), tokens/s, finite logits, each layer's fused MoE output
     against its plain version (calc_diff < TOL) and against the unfused
     path on the same input (< 1e-3 with bf16 act, < 1e-4 with fp8 act),
     a profile; the 'xla' comm (mega_chunks=2, which moves no bit at one
     rank) bitwise equal to the unfused forward, 2 masked launches a layer
     and no mega launch; then the kernel's five instances (bf16, fp8 and FP4 weights,
     bf16 and fp8 act) at one layer's full shapes: each against its plain
     version, twice bitwise, FP4 bitwise the fp8 instance fed the decoded
     weights, packed bitwise raw, each timed beside its bound, its plain
     version, the unfused layer and two bf16 torch.bmm with F.silu between.
  9. the entry points that no model path calls, at DeepSeek-V3 widths, each
     call its own path (its kernel's count 0 just before, read just after):
     the TF32 HC prenorm GEMM of mHC with 4 residual streams (k = 4 x 7168,
     n = 24) at m = 4096 unsplit and at m = 64 in 16 k splits (d within
     1e-5 and sqr_sum within 1e-6 of the plain version, the partials summed
     within 1e-5 of the unsplit call); fp8_einsum bhr,hdr->bhd (MLA's W_UV,
     4096 tokens, 128 heads, rank 512, v 128) on the masked kernel, one
     launch, and fp8_bmm with c on its f32 instance; the bf16 einsums against
     f32 torch.bmm; fp8_gemm_nt_skip_head_mid (128 heads, splits 128 | 64 |
     128) in one dense launch, mid columns exactly zero and the rest bitwise
     the dense kernel's; the contiguous kernel's dual-B form under
     DGT_GROUPED_DUAL_B=1 at the training step's shapes (256 experts, L1 and
     L2, fp8 and bf16) on a seeded uneven layout of 128-row multiples,
     bitwise the contiguous kernel, its own launch count with the contiguous
     kernel's unchanged; fp8_fp4_gemm_nt with a packed FP4 B at 4096 x 4096
     x 7168, bitwise the e4m3 dense kernel fed the decoded codes and per-row
     scales. Each against its plain version (calc_diff < TOL) and timed
     beside its bound and a library call where one computes the same.
 11. the expert-parallel serving forward over a mesh of 8 ranks on this one
     card (devices [cuda:0] * 8: a thread and a CUDA stream a rank) at the
     phase 5 widths, EP 8 (32 experts a rank), [8, 128] tokens (cap 40 a
     slot): the one-sided all-to-all (#15) at the dispatch shape and its
     weight sideband, bitwise the host all-to-all on every rank over three
     back-to-back calls at 8, 2 and 4 ranks; the fused dispatch + L1 (#12)
     at V3's L1, e4m3 and bf16, recv bitwise the all-to-all and out bitwise
     the masked kernel on recv; the general mega kernel (#14) on one
     layer's fp8 weights, pools 1/2/4/8 bitwise each other, every combine
     slab bitwise the one-rank kernel on the rows received (bf16 and fp8
     act), force_general at one rank bitwise the one-rank kernel, planar
     FP4 at 2 ranks bitwise the decoded fp8; each against its plain version
     and timed (the least over the ranks of each rank's event-bracketed
     call, after an L2 flush); then the model forward over the mesh: 'fused'
     on three [8, 128] batches (launches: the general kernel 1 a layer a
     rank, nothing else; tokens/s, peak memory), 'xla' and 'pallas' (one
     chunk: masked 2 a layer a rank, all-to-all 3 under 'pallas') bitwise
     equal, each layer's fused MoE against its plain version and 'xla', the
     logits beside the one-rank forward's, a profile (the device's idle
     share over the union of the streams' busy time).
Then one JSON line of kernel numbers, the card's nvidia-smi line, and the
last line {"ok": true, "device": {...}}.

Times come from CUDA events (deepgemm_tpu_torch/testing/bench.py). The
plain versions and the library yardsticks run f32 products with TF32 off.
bound_ms is the larger of the bytes each call must move (inputs read once,
output written once) over 3.35 TB/s and its operations over the H100's
dense peak for the operand type (989 TFLOP/s bf16, 1979 fp8, 495 TF32).
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
    summed (the calls run one after another), the worst error; no library
    time where a shape has none."""
    total = {key: sum(e[key] for e in entries) for key in ('ms', 'plain_ms', 'bound_ms')}
    library = [e['library_ms'] for e in entries]
    total['library_ms'] = None if None in library else sum(library)
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
    hopper = hopper_instances(reports)
    if hopper:
        log(f'phase 2 Hopper mainloop (csrc/gemm_sm90.cuh): {len(hopper)} instances in '
            f'{sorted({lib for lib, _ in hopper})}; registers at entry '
            f'{sorted({v["registers"] for v in hopper.values()})} (consumers raise theirs to 232 '
            f'with setmaxnreg), shared memory static {max(v["smem"] for v in hopper.values())} '
            f'bytes (the stages are dynamic), spill stores up to '
            f'{max(v["spill_stores"] for v in hopper.values())} bytes, spill loads up to '
            f'{max(v["spill_loads"] for v in hopper.values())} bytes')
        for lib in sorted({lib for lib, _ in hopper}):
            mine = [v for (name, _), v in hopper.items() if name == lib]
            log(f'phase 2 Hopper mainloop in {lib}: {len(mine)} instances, registers at entry '
                f'{sorted({v["registers"] for v in mine})}, spill stores '
                f'{sum(v["spill_stores"] for v in mine)} bytes, spill loads '
                f'{sum(v["spill_loads"] for v in mine)} bytes')
    widen = widen_instances(reports)
    if widen:
        log(f'phase 2 dense forms on bf16 products (csrc/gemm_sm90.cuh widen_kernel, '
            f'dense_dequant): {len(widen)} instances: ' +
            '; '.join(f'{name} registers {v["registers"]} spill stores {v["spill_stores"]} '
                      f'loads {v["spill_loads"]}' for name, v in sorted(widen.items())))
    masked = masked_instances(reports)
    if masked:
        log(f'phase 2 masked kernel and fused dispatch + L1 (csrc/gemm_sm90.cuh widen_body, '
            f'masked and mega_ep): {len(masked)} instances: ' +
            '; '.join(f'{name} registers {v["registers"]} spill stores {v["spill_stores"]} '
                      f'loads {v["spill_loads"]}' for name, v in sorted(masked.items())))
    for lib, found, source in (('mqa_logits', MQA_INSTANCES, 'kLinear'),
                               ('paged_mqa', PAGED_INSTANCES, 'kPaged')):
        found.update(mqa_instances(reports, lib))
        if not found:
            continue
        log(f'phase 2 {lib} (csrc/mqa_sm90.cuh, wgmma + TMA, Source::{source}): {len(found)} '
            f'instances: ' + '; '.join(f'{mqa_instance_name(key, source)} registers '
                                       f'{v["registers"]} spill stores {v["spill_stores"]} loads '
                                       f'{v["spill_loads"]}' for key, v in sorted(found.items())))
        spilled = [mqa_instance_name(k, source) for k, v in found.items()
                   if v['spill_stores'] or v['spill_loads']]
        require(not spilled, f'{lib} instances spill: {spilled}')


# (q bf16, kv bf16, a query's columns) -> registers and spill bytes of the
# MQA logits kernel's instances, from phase 2's ptxas report: the prefill
# entry's (mqa_logits, Source::kLinear) and the paged entries'
# (paged_mqa, Source::kPaged)
MQA_INSTANCES = {}
PAGED_INSTANCES = {}


def mqa_instance_name(key, source='kLinear'):
    """The template instance, as csrc/mqa_sm90.cuh spells its arguments."""
    q_bf16, kv_bf16, columns = key
    elem = lambda bf16: 'kBf16' if bf16 else 'kE4m3'
    return f'mqa_logits_sm90<{elem(q_bf16)}, {elem(kv_bf16)}, {columns}, Source::{source}>'


def mqa_instances(reports, lib='mqa_logits'):
    """{(q bf16, kv bf16, a query's columns): registers, spill bytes} of the MQA
    logits kernel's instances (dgt_mqa90::mqa_logits_sm90) in library ``lib``,
    from ptxas -v."""
    import re
    found, current = {}, None
    for line in reports.get(lib, '').splitlines():
        entry = re.search(r"entry function '\w*mqa_logits_sm90"
                          r"ILNS_4ElemE(\d)ELS1_(\d)ELi(\d+)E", line)
        if entry:
            current = tuple(int(x) for x in entry.groups())
            found[current] = dict(registers=0, spill_stores=0, spill_loads=0)
            continue
        if "entry function" in line:
            current = None
        if current is None:
            continue
        spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if spill:
            found[current].update(spill_stores=int(spill.group(1)),
                                  spill_loads=int(spill.group(2)))
        used = re.search(r'Used (\d+) registers', line)
        if used:
            found[current]['registers'] = int(used.group(1))
    return found


def widen_instances(reports):
    """{instance: registers, spill bytes} of the dense forms on bf16 products
    (dgt::sm90::widen_kernel in dense_dequant), from ptxas -v."""
    import re
    kinds = {'0': 'kE4m3', '1': 'kBf16'}
    found = {}
    for key, v in hopper_instances({'dense_dequant': reports.get('dense_dequant', '')}).items():
        name = re.search(r'widen_kernelILi(\d+)ELi(\d+)E(13__nv_bfloat16|f)LNS0_7OperandE(\d)'
                         r'ELS\d_(\d)ELb(\d)E', key[1])
        if name:
            bm, bn, out, a, b, dequant = name.groups()
            found[f'widen_kernel<{bm}, {bn}, {"bf16" if out != "f" else "f32"}, {kinds[a]}, '
                  f'{kinds[b]}, {"dequant" if dequant == "1" else "promote"}>'] = v
    return found


def masked_instances(reports):
    """{instance: registers, spill bytes} of the masked kernel
    (dgt::sm90::masked_kernel in masked) and the fused dispatch + L1
    (dgt::ep::dispatch_gemm_kernel in mega_ep), from ptxas -v."""
    import re
    kinds = {'0': 'kE4m3', '1': 'kBf16'}
    found = {}
    for key, v in hopper_instances({lib: reports.get(lib, '')
                                    for lib in ('masked', 'mega_ep')}).items():
        masked = re.search(r'masked_kernelILi(\d+)E(13__nv_bfloat16|f)LN\w*?7OperandE(\d)E', key[1])
        dispatch = re.search(r'dispatch_gemm_kernelILi(\d+)ELN\w*?7OperandE(\d)E', key[1])
        if masked:
            bm, out, kind = masked.groups()
            found[f'masked_kernel<{bm}, {"f32" if out == "f" else "bf16"}, {kinds[kind]}>'] = v
        elif dispatch:
            bm, kind = dispatch.groups()
            found[f'dispatch_gemm_kernel<{bm}, {kinds[kind]}>'] = v
    return found


def hopper_instances(reports):
    """{(library, kernel): registers, static smem, spill bytes} of the
    Hopper mainloop's instances (dgt::sm90::gemm_kernel, widen_kernel and
    masked_kernel, dgt::ep::dispatch_gemm_kernel), from ptxas -v."""
    import re
    found, current = {}, None
    for lib, text in reports.items():
        for line in text.splitlines():
            entry = re.search(r"entry function '(\w+)'", line)
            if entry:
                hopper = any(k in entry.group(1) for k in (
                    'sm9011gemm_kernel', 'sm9012widen_kernel', 'sm9013masked_kernel',
                    'ep20dispatch_gemm_kernel'))
                current = (lib, entry.group(1)) if hopper else None
                if current:
                    found[current] = dict(registers=0, smem=0, spill_stores=0, spill_loads=0)
                continue
            if current is None:
                continue
            spill = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
            if spill:
                found[current].update(spill_stores=int(spill.group(1)),
                                      spill_loads=int(spill.group(2)))
            used = re.search(r'Used (\d+) registers', line)
            if used:
                found[current]['registers'] = int(used.group(1))
                smem = re.search(r'(\d+) bytes smem', line)
                found[current]['smem'] = int(smem.group(1)) if smem else 0
    return found


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

        # the library entry a user calls: one counted launch, the same bits
        # (the kernel is deterministic: a second launch gives them again)
        dense.launches = 0
        d_api = dgt.fp8_gemm_nt((aq, sfa), (bq, sfb))
        torch.cuda.synchronize()
        require(dense.launches == 1, f'fp8_gemm_nt launched the dense kernel {dense.launches} times')
        require(torch.equal(d_api, d_k), 'fp8_gemm_nt differs from the kernel wrapper')

        ms = bench_kernel(kernel, iters=20)
        plain_ms = bench_kernel(plain, iters=3, warmup=1)
        library_ms = bench_kernel(library, iters=20)
        nbytes = sum(t.numel() * t.element_size() for t in (aq, bq, sfa, sfb)) + 2 * m * n
        bound = arch.bound_ms(nbytes, 2 * m * n * k, 'fp8')
        entries.append(dict(shape=[m, n, k], **numbers(ms, plain_ms, library_ms, err, bound)))
        log(f'phase 3 dense m={m} n={n} k={k}: calc_diff={diff:.3e} (limit {TOL}) '
            f'max_abs_err={err:.4g} vs_bf16_matmul={quant:.3e} kernel_ms={ms:.4f} '
            f'plain_ms={plain_ms:.4f} library_ms(torch.matmul bf16)={library_ms:.4f} '
            f'bound_ms={bound[0]:.4f} ({bound[1]}) TFLOPS={2 * m * n * k / ms / 1e9:.1f} '
            f'fp8_gemm_nt_launches=1, bitwise the wrapper\'s launch')
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
            bound = arch.bound_ms(nbytes, 2 * g * max_m * n * k, kind)
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

    def reversed_plain(a, b, masked_m, sfa=None, sfb=None, gran_n=128,
                       out_dtype=torch.bfloat16):
        require(a.shape[-1] % 128 == 0, 'k must be whole 128-deep scale blocks')
        return plain(flip(a), flip(b), masked_m, flip(sfa), flip(sfb), gran_n, out_dtype)

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
    from deepgemm_tpu_torch.utils.math import topk_stable
    from deepgemm_tpu_torch.testing import calc_diff
    topk, experts, last = cfg.topk, cfg.num_experts, len(params['layers']) - 1
    cap = moe_capacity(tokens.numel(), topk, experts, cfg.capacity_factor)

    def kept_experts(router):
        idx = topk_stable(router, topk)[1]
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
        top_p_values, top_p_indices = topk_stable(router['plain'], topk + 1)
        margin = top_p_values[:, topk - 1] - top_p_values[:, topk]
        kept_p = kept_experts(router['plain'])[1]
        entry.update(median_margin=margin.median().item(),
                     plain_dropped=topk * tokens.numel() - int(kept_p.sum()))
        for p in reached:
            idx, kept = kept_experts(router[p])
            missing = (top_p_indices[:, :topk, None] != idx[:, None, :]).all(-1).sum(-1)
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


def profile(fn, label, what, host_ops=0):
    """One call of ``fn`` under torch.profiler: its wall time, the time of
    the device's own events (kernels, copies, sets) summed, the names that
    take the most of it, and the ``host_ops`` host operations that take the
    most host time of their own. Returns the device events' {name: (us,
    calls)} and the wall and device ms, or None if the profiler saw no
    device event."""
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
        return None
    device_ms = sum(us for us, _ in by_name.values()) / 1e3
    log(f'profile {label}: wall_ms={wall_ms:.3f} device_ms={device_ms:.3f} '
        f'device_idle_share={1 - device_ms / wall_ms:.4f} ({what}, under the profiler)')
    for name, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f'  {us / 1e3:10.3f} ms device, {calls:6d} calls: {name[:130]}')
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:host_ops]
    for e in host:
        log(f'  {e.self_cpu_time_total / 1e3:10.3f} ms host (self), {e.count:6d} calls: '
            f'{e.key[:130]}')
    return dict(by_name=by_name, wall_ms=wall_ms, device_ms=device_ms)


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
PER_STEP = dict(dense=6, contiguous=4, k_grouped=2, masked=0, relayout=4)
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
        require(kw['c'] is None and not (kw['a_mn'] or kw['b_mn']) and kw['strategy'] == 'promote',
                'the step calls the NT promote form without c')
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

    hooks = ((gemm, 'dense_gemm', dense_call),
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


def time_relayout(x, sizes, arch, name):
    """The FP8 k-grouped wrapper's relayout of one TN operand at full shape
    (the transposing gather kernel): bitwise its plain version, timed beside
    it and beside x.t().contiguous(), which computes the same function where
    every group is a whole 128 rows deep, as in the training step."""
    from deepgemm_tpu_torch.kernels import k_grouped
    from deepgemm_tpu_torch.kernels.common import k_major_relayout, k_major_relayout_plain
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    starts, sz, _ = k_grouped.compute_k_group_metadata(sizes, False)
    ldk = 128 * int(((sz + 127) // 128).sum())
    src = k_grouped._k_major_columns(starts, sz, x.shape[0], 128, ldk)[0]
    got = k_major_relayout(x, src, 'k_grouped')
    want = k_major_relayout_plain(x, src)
    library = lambda: x.view(torch.uint8).t().contiguous()
    require(torch.equal(got.view(torch.uint8), want.view(torch.uint8)),
            f'relayout {name}: the kernel is not bitwise its plain version')
    same = torch.equal(library(), got.view(torch.uint8))
    del got, want
    ms = bench_kernel(lambda: k_major_relayout(x, src, 'k_grouped'), iters=5)
    plain_ms = bench_kernel(lambda: k_major_relayout_plain(x, src), iters=2, warmup=1)
    library_ms = bench_kernel(library, iters=5)
    nbytes = x.numel() + x.shape[1] * ldk + 4 * ldk
    bound = arch.bound_ms(nbytes, 0, 'fp8')
    log(f'phase 6 time relayout {name} [{x.shape[0]} x {x.shape[1]} -> {x.shape[1]} x {ldk}]: '
        f'bitwise plain; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} '
        f'library_ms(x.t().contiguous(), {"the same bytes" if same else "other bytes"})='
        f'{library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) GB/s={nbytes / ms / 1e6:.1f}')
    return dict(name=name, shape=[x.shape[0], x.shape[1], ldk],
                **numbers(ms, plain_ms, library_ms, 0.0, bound))


def time_train_kernels(results, gen, arch, time_plain=True):
    """Each kernel call of the step, timed at its full shapes on seeded
    inputs of the step's kinds (the kernel, its plain version if
    ``time_plain``, one bf16 PyTorch call on the same shapes), with its bound;
    each k-grouped call's relayout timed on its own where the package has
    one. Returns per-kind lists of number dicts (the relayouts under
    'relayout')."""
    from deepgemm_tpu_torch.kernels import dense, grouped, k_grouped
    from deepgemm_tpu_torch.testing import count_bytes
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import (per_block_cast_to_fp8, per_channel_cast_to_fp8,
                                               per_token_cast_to_fp8, quantize_experts)
    entries = {kind: [] for kind in (*CALL_NAMES, 'relayout')}
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
            plain_ms = bench_kernel(plain, iters=1, warmup=1) if time_plain else None
            library_ms = bench_kernel(library, iters=5)
            bound = arch.bound_ms(count_bytes(*inputs) + out_bytes, flops, 'fp8')
            extra, share = {}, ''
            if kind == 'k_grouped' and hasattr(k_grouped, 'tn_relayout'):
                moved = [time_relayout(x, sizes, arch, f'{name} {label}')
                         for x, label in ((aq, 'A'), (bq, 'B'))]
                entries['relayout'] += moved
                relayout_ms = sum(e['ms'] for e in moved)
                extra = dict(relayout_ms=relayout_ms, relayout_share=relayout_ms / ms)
                share = (f'relayout_ms={relayout_ms:.4f} ({100 * relayout_ms / ms:.1f}% of the '
                         f'call) ')
            entries[kind].append(dict(name=name, shape=list(rec['shape']), check_calc_diff=rec['diff'],
                                      **extra, **numbers(ms, plain_ms, library_ms, err, bound)))
            plain_text = f'{plain_ms:.4f}' if plain_ms is not None else 'not timed'
            log(f'phase 6 time {kind} {name} shape={rec["shape"]}: kernel_ms={ms:.4f} {share}'
                f'plain_ms={plain_text} library_ms(bf16 torch.{"matmul" if kind == "dense" else "bmm"})='
                f'{library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) '
                f'GB/s={(count_bytes(*inputs) + out_bytes) / ms / 1e6:.1f} '
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
    from deepgemm_tpu_torch.kernels import common, dense, grouped, k_grouped
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
                    bf16=grouped.contiguous_launches['bf16'] + k_grouped.launches['bf16'],
                    relayout=common.relayout_launches['k_grouped'])

    # the main path: counts at 0 just before, read just after the steps
    dense.launches = 0
    grouped.launches.update(bf16=0, fp8=0)
    grouped.contiguous_launches.update(bf16=0, fp8=0)
    grouped.contiguous_form_launches.clear()
    k_grouped.launches.update(bf16=0, fp8=0)
    common.relayout_launches.update(dense=0, k_grouped=0)
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
    forms = dict(grouped.contiguous_form_launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {kind: TRAIN_STEPS * n for kind, n in PER_STEP.items()}
    require(seen == dict(want, bf16=0), f'train: launches {seen}, expected {want} and no bf16')
    require(forms == {grouped.contiguous_form('fp8', 'nt', 128): want['contiguous']},
            f'train: contiguous launches by form {forms}')
    require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
            f'train: losses {losses} are not finite and falling')
    tokens_per_s = (TRAIN_STEPS - 1) * tokens.numel() / sum(seconds[1:])
    log(f'phase 6 train: launches={seen} (per step {PER_STEP}; contiguous by form {forms}) '
        f'losses={losses} '
        f'seconds per step {[round(v, 4) for v in seconds]} (the first with warm-up and '
        f'the recording of its kernel calls) tokens/s={tokens_per_s:.1f} '
        f'peak_mem={peak_gb:.2f} GB (steps 2-{TRAIN_STEPS}; step 1 with its recordings '
        f'{peak_capture_gb:.2f} GB)')
    profile(lambda: train_step(params, tokens, targets, cfg, lr=TRAIN_LR), 'train step',
            f'one {TRAIN_SHAPE} step after {TRAIN_STEPS}')
    del params
    torch.cuda.empty_cache()
    entries = time_train_kernels(results, gen, arch)
    return entries, dict({kind: seen[kind] for kind in (*CALL_NAMES, 'relayout')},
                         contiguous_forms=forms)


# Phase 7: the continuous-batching engine over the lightning indexer. The
# indexer at DeepSeek-V3.2-Exp's published widths (its config.json:
# index_n_heads 64, index_head_dim 128, index_topk 2048), an e4m3 cache with
# one f32 scale a token in pages of 64 tokens; the attention streams at the
# flagship's 128 heads x 128 in bf16 (V3.2 decodes with MLA over a 576-wide
# shared latent; the engine's contract is per-head K/V of one shape).
SERVE = dict(max_slots=64, max_pages_per_seq=128, num_blocks=8256, block_kv=64,
             num_heads=128, head_dim=128, index_heads=64, index_dim=128, topk=2048)
SERVE_STEPS = 8
PROMPT_RANGE = (4096, 7936)
LATE = dict(request=64, prompt=6000, step=4, finishes=1)   # at step 4: 1 finishes, 64 comes
INVARIANCE_REQUESTS = (0, 64)
ATTN_CHECK_ROWS = 8          # seeded slots whose attention is held to the plain version
PREFILL_LEN, PREFILL_ROWS = 8192, 64
MQA_BENCH = (2048, 8192, 64, 128)       # sq, skv, h, d (bench.py:723)


def token_id(request, step):
    return 100 * request + step


def _hashed_uniform(tokens, n):
    """[slots, n] f32 uniform in [-sqrt(3), sqrt(3)] (unit variance): a 32-bit
    integer hash of each slot's token and each element's index, so every
    value depends on its token and index alone."""
    idx = torch.arange(n, device=tokens.device, dtype=torch.int64)
    x = ((tokens.long()[:, None] + 7919) * 0x9E3779B1 + idx * 0x85EBCA77) & 0xFFFFFFFF
    for _ in range(2):
        x = ((x ^ (x >> 16)) * 0x45D9F3B) & 0xFFFFFFFF
    x = x ^ (x >> 16)
    return (x.float() * 2.0 ** -32 - 0.5) * math.sqrt(12.0)


def decode_streams(tokens):
    """One decode step's streams for a [slots] token batch (the engine's
    embed_fn; a server plugs the model's projections in here): each slot's
    a hash of its token alone, so a sequence's streams never depend on the
    batch, made by a few elementwise launches for the whole batch."""
    h, d = SERVE['num_heads'], SERVE['head_dim']
    hi, di = SERVE['index_heads'], SERVE['index_dim']
    sizes = (h * d, hi * di, hi, h * d, h * d, di, 1)
    q, iq, iw, k, v, ik, isf = torch.split(_hashed_uniform(tokens, sum(sizes)), sizes, dim=1)
    s = tokens.shape[0]
    return (q.reshape(s, h, d).bfloat16(), iq.reshape(s, hi, di).bfloat16(), iw * hi ** -0.5,
            k.reshape(s, h, d).bfloat16(), v.reshape(s, h, d).bfloat16(),
            ik.to(torch.float8_e4m3fn), isf[:, 0].abs() * 0.01 + 0.005)


def prompt_streams(seed, request, t):
    """A prompt's k, v [t, h, d] bf16, index keys [t, di] e4m3 and scales [t]."""
    h, d, di = SERVE['num_heads'], SERVE['head_dim'], SERVE['index_dim']
    g = torch.Generator(device='cuda').manual_seed(seed * 1000 + request)
    k = torch.randn((t, h, d), generator=g, device='cuda').bfloat16()
    v = torch.randn((t, h, d), generator=g, device='cuda').bfloat16()
    ik = torch.randn((t, di), generator=g, device='cuda').clamp(-448, 448).to(torch.float8_e4m3fn)
    return k, v, ik, torch.rand(t, generator=g, device='cuda') * 0.01 + 0.005


ALL_KINDS = ('paged', 'mqa', 'attn', 'fused', 'topk')


@contextlib.contextmanager
def serving_hooks(records, seed, kinds=ALL_KINDS):
    """While open, the indexer's calls of ``kinds`` are recorded: the paged
    MQA call and the MQA logits call with clones of their inputs and output,
    the attention call with clones of ATTN_CHECK_ROWS seeded rows of its
    inputs and output, the gather-fused attention call with clones of its q,
    tok and valid (the cache views as they are), each top-k selection
    (sorted per row). The wrappers are called as they are, once each."""
    from deepgemm_tpu_torch.kernels import mqa_logits, paged_mqa, sparse_attn
    from deepgemm_tpu_torch.models import indexer
    gen = torch.Generator().manual_seed(seed)
    clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x

    def paged_call(args, kw, out):
        return dict(kind='paged', args=tuple(map(clone, args)), kw=dict(kw), out=out.clone())

    def mqa_call(args, kw, out):
        return dict(kind='mqa', args=tuple(map(clone, args)), kw=dict(kw), out=out.clone())

    def attn_call(args, kw, out):
        q, k_sel, v_sel, valid, scale = args
        rows = torch.randperm(q.shape[0], generator=gen)[:ATTN_CHECK_ROWS].sort().values.cuda()
        return dict(kind='attn', rows=rows, scale=scale, out=out[rows].clone(),
                    args=tuple(x[rows].clone() for x in (q, k_sel, v_sel, valid)),
                    shape=(q.shape[0], *k_sel.shape[1:]))

    def topk_call(args, kw, out):
        return dict(kind='topk', sel=out[0].sort(dim=1).values, valid=out[1].clone())

    def fused_call(args, kw, out):
        q, k_rows, v_rows, tok, valid, scale = args       # the cache views: no copy
        return dict(kind='fused', q=q.clone(), k_rows=k_rows, v_rows=v_rows, tok=tok.clone(),
                    valid=valid.clone(), scale=scale)

    hooks = [hook for hook in ((paged_mqa, 'paged_mqa_logits', paged_call),
                               (mqa_logits, 'mqa_logits', mqa_call),
                               (sparse_attn, 'gathered_attention', attn_call),
                               (sparse_attn, 'sparse_attention_paged', fused_call),
                               (indexer, '_topk_indices', topk_call))
             if hook[2].__name__.split('_')[0] in kinds]
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


def prompt_lengths(seed):
    g = torch.Generator().manual_seed(seed)
    lengths = torch.randint(PROMPT_RANGE[0], PROMPT_RANGE[1] + 1, (SERVE['max_slots'],),
                            generator=g).tolist()
    out = dict(enumerate(lengths))
    out[LATE['request']] = LATE['prompt']
    return out


def serve(seed, requests, on_step=None):
    """Drives a fresh engine through the phase's script for ``requests``
    (a subset of the 64 prompts and the late one): admission and prefill,
    SERVE_STEPS decode steps, request LATE['finishes'] finished and request
    LATE['request'] admitted and prefilled before step LATE['step'].
    ``on_step(step, engine, tokens)`` runs around each step's call (a context
    manager factory, or None). Returns (engine, outputs by (request, step),
    the slot of each request by step, seconds per step, active slots per
    step, prefill seconds)."""
    from deepgemm_tpu_torch.serving import ContinuousBatcher
    lengths = prompt_lengths(seed)
    engine = ContinuousBatcher(**SERVE, embed_fn=decode_streams, device='cuda')
    ids, outs, slots, seconds, active, prefill_s = {}, {}, {}, [], [], 0.0

    def admit(request):
        nonlocal prefill_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids[request] = engine.admit(lengths[request])
        require(ids[request] is not None, f'request {request} was not admitted')
        engine.prefill(ids[request], *prompt_streams(seed, request, lengths[request]))
        torch.cuda.synchronize()
        prefill_s += time.perf_counter() - t0

    for request in requests:
        if request != LATE['request']:
            admit(request)
    for step in range(1, SERVE_STEPS + 1):
        if step == LATE['step']:
            if LATE['finishes'] in ids:
                engine.finish(ids.pop(LATE['finishes']))
            if LATE['request'] in requests:
                admit(LATE['request'])
        tokens = {sid: token_id(r, step) for r, sid in ids.items()}
        slots[step] = {r: engine._seq(sid).slot for r, sid in ids.items()}
        ctx = on_step(step, engine, tokens) if on_step else contextlib.nullcontext()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ctx:
            res = engine.step(tokens)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        active.append(len(tokens))
        for r, sid in ids.items():
            outs[r, step] = res[sid].clone()
    return engine, outs, slots, seconds, active, prefill_s


def free_engine(engine):
    engine.cache = None
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_paged(rec):
    """Step 1's paged MQA call: the kernel's output against its plain
    version on the same inputs (calc_diff over the finite entries, -inf at
    the same places), then the zero-copy entry through the user's entry
    point on the same cache (its own path: counts at 0 just before, read just
    after), bitwise equal. Returns (the diff, the max error, zero-copy
    launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import paged_mqa
    from deepgemm_tpu_torch.kernels.common import plain_versions
    q, kv, sf, w, ctx, bt, max_len = rec['args']
    with plain_versions():
        want = paged_mqa.paged_mqa_logits(*rec['args'], **rec['kw'])
    got = rec['out']
    require(torch.equal(torch.isneginf(got), torch.isneginf(want)),
            'paged MQA: -inf at other places than the plain version')
    fin = ~torch.isneginf(want)
    diff, err = compare(got[fin], want[fin])
    require(diff < TOL, f'paged MQA: calc_diff {diff} against the plain version')
    zero_indexer_counts()
    zero_copy = dgt.fp8_fp4_paged_mqa_logits((q, None), (kv, sf), w, ctx, bt, None, max_len,
                                             strategy='paged')
    torch.cuda.synchronize()
    zc_counts = indexer_counts()
    require(zc_counts == dict(gather=0, paged=1, mqa=0, attn=0, fused=0),
            f'the zero-copy path launched {zc_counts}')
    require(torch.equal(zero_copy, got), 'the zero-copy entry differs from the gather entry')
    zc_diff, zc_err = compare(zero_copy[fin], want[fin])
    log(f'phase 7 check paged MQA step 1 [{got.shape[0]} rows x {max_len}]: calc_diff={diff:.3e} '
        f'(limit {TOL}, {int(fin.sum())} finite entries, -inf at the same places) '
        f'max_abs_err={err:.4g}; zero-copy path launches={zc_counts}, bitwise equal to gather, '
        f'against the plain version calc_diff={zc_diff:.3e} max_abs_err={zc_err:.4g}')
    return (diff, err), (zc_diff, zc_err), zc_counts['paged']


def check_attention(rec, label):
    from deepgemm_tpu_torch.kernels import sparse_attn
    q, k_sel, v_sel, valid = rec['args']
    want = sparse_attn.gathered_attention_plain(q, k_sel, v_sel, valid, rec['scale'])
    diff, err = compare(rec['out'], want)
    require(diff < TOL, f'attention ({label}): calc_diff {diff} against the plain version')
    log(f'phase 7 check attention {label} on {ATTN_CHECK_ROWS} seeded rows '
        f'{rec["rows"].tolist()} of {list(rec["shape"])}: calc_diff={diff:.3e} (limit {TOL}) '
        f'max_abs_err={err:.4g}')
    return diff, err


def time_decode_kernels(rec_paged, engine, arch):
    """The decode path's kernels at their full shapes on step 1's inputs (the
    paged MQA entries) and on the engine's current state (the attention over
    all 64 slots' selected rows): kernel, plain version, library yardstick,
    bound. Returns {name: numbers}."""
    import torch.nn.functional as F
    from deepgemm_tpu_torch.kernels import paged_mqa, sparse_attn
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.models import indexer
    from deepgemm_tpu_torch.testing.bench import bench_host, bench_kernel
    q, kv, sf, w, ctx, bt, max_len = rec_paged['args']
    b, nn, h, d = q.shape
    hi = paged_mqa.row_bounds(ctx, nn)
    bt = bt.int().clamp(0, kv.shape[0] - 1)
    kv_lin, sf_lin = paged_mqa.linearise(kv, sf, bt)
    need = int(ctx.clamp(max=max_len).sum())            # cache rows the data needs
    nbytes = need * (d + 4) + q.numel() + w.numel() * 4 + hi.numel() * 4 + b * nn * max_len * 4
    bound = arch.bound_ms(nbytes, 2 * need * nn * h * d, 'fp8')
    q16, kv16 = q.view(b, nn * h, d).bfloat16(), kv_lin.bfloat16()
    library_ms = bench_kernel(lambda: torch.bmm(q16, kv16.transpose(1, 2)), iters=10)
    gather_ms = bench_kernel(lambda: paged_mqa.linearise(kv, sf, bt), iters=10)
    out = {}
    for name, fn in (('gather', lambda: paged_mqa.paged_mqa_logits_gather(
                         q, kv_lin, sf_lin, w, hi, max_len)),
                     ('paged', lambda: paged_mqa.paged_mqa_logits_paged(
                         q, kv, sf, w, hi, bt, max_len))):
        ms, device, host = (bench_kernel(fn, iters=20), bench_kernel(fn, iters=20, hide_host=True),
                            bench_host(fn))
        with plain_versions():
            plain_ms = bench_kernel(fn, iters=2, warmup=1)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound[0],
                         bound_by=bound[1], shape=[b, nn, h, d, max_len], cache_rows=need,
                         device_ms=device, host_ms=host)
        log(f'phase 7 time paged MQA {name} [B={b} next_n={nn} h={h} d={d} max_len={max_len}, '
            f'{need} cache rows]: kernel_ms={ms:.4f} (the call, event-bracketed; on the device '
            f'with the host work hidden {device:.4f}, the host work {host:.4f}) '
            f'plain_ms={plain_ms:.4f} library_ms(torch.bmm bf16 q x kv_lin^T)={library_ms:.4f} '
            f'bound_ms={bound[0]:.4f} ({bound[1]}) GB/s={nbytes / device / 1e6:.1f} on the device'
            + (f' (the linearising gather before it: {gather_ms:.4f} ms)'
               if name == 'gather' else ' (its plain version linearises the pages first)'))
    del q16, kv16, kv_lin, sf_lin

    # the attention over the current state's selection, all slots
    c = engine.cache
    tokens = torch.arange(SERVE['max_slots'], device='cuda', dtype=torch.int32) + 9000
    qd, iq, iw = decode_streams(tokens)[:3]
    ctx_now = torch.from_numpy(engine.context_lens).cuda()
    bt_now = torch.from_numpy(engine.block_table).cuda()
    logits = paged_mqa.paged_mqa_logits(indexer._index_q_fp8(iq)[:, None], c.ik_pages,
                                        c.isf_pages, iw, ctx_now, bt_now, engine.max_context_len)
    sel, valid = indexer._topk_indices(logits, SERVE['topk'])
    pos = sel.long()
    tok = (bt_now.long().gather(1, pos // SERVE['block_kv']) * SERVE['block_kv']
           + pos % SERVE['block_kv']).reshape(-1)
    rows, t = sel.shape
    h_a, d_a = SERVE['num_heads'], SERVE['head_dim']
    flat_gather = lambda: (c.k_pages.view(-1, h_a, d_a).index_select(0, tok),
                           c.v_pages.view(-1, h_a, d_a).index_select(0, tok))
    gather_attn_ms = bench_kernel(flat_gather, iters=3)
    k_sel, v_sel = (x.view(rows, t, h_a, d_a) for x in flat_gather())
    scale = d_a ** -0.5
    ms = bench_kernel(lambda: sparse_attn.gathered_attention(qd, k_sel, v_sel, valid, scale),
                      iters=5)
    sub = slice(0, ATTN_CHECK_ROWS)
    plain_ms = bench_kernel(lambda: sparse_attn.gathered_attention_plain(
        qd[sub], k_sel[sub], v_sel[sub], valid[sub], scale), iters=2, warmup=1)
    mask = valid[:, None, None, :]
    library_ms = bench_kernel(lambda: F.scaled_dot_product_attention(
        qd[:, :, None, :], k_sel.transpose(1, 2), v_sel.transpose(1, 2), attn_mask=mask,
        scale=scale), iters=3)
    n_valid = int(valid.sum())
    nbytes = 2 * n_valid * h_a * d_a * 2 + 2 * qd.numel() * 2 + valid.numel()
    bound = arch.bound_ms(nbytes, 4 * n_valid * h_a * d_a, 'bf16')
    out['attn'] = dict(ms=ms, plain_ms=plain_ms, plain_rows=ATTN_CHECK_ROWS,
                       library_ms=library_ms, bound_ms=bound[0], bound_by=bound[1],
                       shape=[rows, t, h_a, d_a], flat_gather_ms=gather_attn_ms)
    log(f'phase 7 time attention [{rows} rows, topk {t}, h {h_a}, d {d_a}; {n_valid} valid]: '
        f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (on {ATTN_CHECK_ROWS} rows) '
        f'library_ms(F.scaled_dot_product_attention over the gathered rows)={library_ms:.4f} '
        f'bound_ms={bound[0]:.4f} ({bound[1]}) GB/s={nbytes / ms / 1e6:.1f}; the flat token '
        f'gather before it {gather_attn_ms:.4f} ms')
    return out


def prefill_inputs(seed):
    """The prefill path's streams for the last PREFILL_ROWS query rows of
    one PREFILL_LEN-token prompt: attention k, v [n, h, d] and q [rows, h,
    d] bf16; the indexer's iq [rows, hi, di], ikv [n, di] bf16 and iw [rows,
    hi]; ks, ke (causal)."""
    h, d, hi, di = (SERVE[k] for k in ('num_heads', 'head_dim', 'index_heads', 'index_dim'))
    g = torch.Generator(device='cuda').manual_seed(seed + 7)
    n, rows = PREFILL_LEN, PREFILL_ROWS
    k = torch.randn((n, h, d), generator=g, device='cuda').bfloat16()
    v = torch.randn((n, h, d), generator=g, device='cuda').bfloat16()
    q = torch.randn((rows, h, d), generator=g, device='cuda').bfloat16()
    iq = torch.randn((rows, hi, di), generator=g, device='cuda').bfloat16()
    ikv = torch.randn((n, di), generator=g, device='cuda').bfloat16()
    iw = torch.randn((rows, hi), generator=g, device='cuda') * hi ** -0.5
    ks = torch.zeros(rows, dtype=torch.int32, device='cuda')
    ke = torch.arange(n - rows + 1, n + 1, dtype=torch.int32, device='cuda')   # causal
    return k, v, q, iq, ikv, iw, ks, ke


def mqa_calls(seed):
    """The MQA logits kernel's timed calls, (q, kv, kv_sf, weights, ks, ke)
    each: the prefill path's (the indexer's e4m3 cast of iq and ikv), the
    JAX bench's prefill shape (e4m3), that shape's operands re-quantized to
    FP4 and decoded to bf16 (the bf16 instance, as the FP4 op launches it),
    and its FP4 q decoded to bf16 with the e4m3 kv (the register-A
    instance: kv widened in registers)."""
    from deepgemm_tpu_torch.ops import attention as attn_ops
    from deepgemm_tpu_torch.utils.math import cast_to_fp8, per_custom_dims_cast_to_fp8
    _, _, _, iq, ikv, iw, ks, ke = prefill_inputs(seed)
    ikv8, isf = per_custom_dims_cast_to_fp8(ikv, (0,), use_ue8m0=False)
    q8, kv8, sf, w, bks, bke = bench_mqa_inputs(seed)
    q4, kv4 = fp4_rows(q8.float()), fp4_rows(kv8.float() * sf[:, None])
    return {'path': (cast_to_fp8(iq.float()), ikv8, isf, iw, ks, ke),
            'bench': (q8, kv8, sf, w, bks, bke),
            'bench_bf16': (attn_ops._decode_fp4_rows(*q4), attn_ops._decode_fp4_rows(*kv4),
                           None, w, bks, bke),
            'bench_bf16_q': (attn_ops._decode_fp4_rows(*q4), kv8, sf, w, bks, bke)}


def time_mqa(label, call, arch, time_plain=True):
    """One MQA logits call timed: the kernel, its plain version (one launch),
    torch.matmul bf16 q2 x kv^T, and the bound over the pairs inside a
    window (e4m3 pairs at the fp8 rate, the bf16 instance at bf16's)."""
    from deepgemm_tpu_torch.kernels import mqa_logits
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    q, kv, sf, w, lo, hi = call
    (sq, h, d), skv = q.shape, kv.shape[0]
    fn = lambda: mqa_logits.mqa_logits(q, kv, w, lo, hi, kv_sf=sf)
    ms, device_ms = bench_kernel(fn, iters=10), bench_kernel(fn, iters=10, hide_host=True)
    plain_ms = None
    if time_plain:
        with plain_versions():
            plain_ms = bench_kernel(fn, iters=1, warmup=1)
    q16, kv16 = q.reshape(sq * h, d).bfloat16(), kv.bfloat16()
    library_ms = bench_kernel(lambda: torch.matmul(q16, kv16.t()), iters=10)
    del q16, kv16
    pairs = int((hi - lo).clamp(min=0).sum())          # (row, column) pairs in a window
    nbytes = (q.numel() * q.element_size() + kv.numel() * kv.element_size()
              + (0 if sf is None else sf.numel() * 4) + w.numel() * 4 + 8 * sq + sq * skv * 4)
    e4m3 = q.dtype == kv.dtype == torch.float8_e4m3fn
    bound = arch.bound_ms(nbytes, 2 * pairs * h * d, 'fp8' if e4m3 else 'bf16')
    log(f'phase 7 time MQA logits {label} [sq={sq} skv={skv} h={h} d={d}, {q.dtype} x '
        f'{kv.dtype}, {pairs} window pairs]: kernel_ms={ms:.4f} (device_ms={device_ms:.4f}, '
        f'host work hidden) plain_ms='
        f'{"not timed" if plain_ms is None else f"{plain_ms:.4f}"} '
        f'library_ms(torch.matmul bf16 q2 x kv^T)={library_ms:.4f} bound_ms={bound[0]:.4f} '
        f'({bound[1]}) TFLOPS={2 * pairs * h * d / ms / 1e9:.1f}')
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound[0], bound_by=bound[1], shape=[sq, skv, h, d])


def phase_prefill(seed, arch):
    """The prefill path: indexer_sparse_attention on the last PREFILL_ROWS
    query rows of one PREFILL_LEN-token prompt (counts at 0 just before,
    read just after: MQA logits 1, attention 1), each call held to its plain
    version, the MQA logits instance that launched named (its ptxas report:
    no spill); then the MQA logits kernel at the JAX bench's prefill shape
    against its plain version, and both shapes timed; then the op with FP4
    q and kv at the bench shape (its own path: the bf16 instance launches
    once), against its plain version, the instance timed on the decoded
    operands beside the e4m3 one."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import mqa_logits
    from deepgemm_tpu_torch.kernels.common import plain_versions
    rows = PREFILL_ROWS
    k, v, q, iq, ikv, iw, ks, ke = prefill_inputs(seed)
    records = []
    zero_indexer_counts()
    with serving_hooks(records, seed):
        out = dgt.indexer_sparse_attention(q, k, v, iq, ikv, iw, ks, ke, SERVE['topk'])
    torch.cuda.synchronize()
    counts = indexer_counts()
    require(counts == dict(gather=0, paged=0, mqa=1, attn=1, fused=0),
            f'prefill launches {counts}')
    launched = mqa_logits.last_instance
    require(launched in MQA_INSTANCES or not MQA_INSTANCES,
            f'prefill MQA logits launched {launched}, not one of phase 2\'s instances')
    require(tuple(out.shape) == tuple(q.shape) and torch.isfinite(out.float()).all().item(),
            f'prefill output {tuple(out.shape)} not finite')
    by_kind = {r['kind']: r for r in records}
    rec = by_kind['mqa']
    with plain_versions():
        want = mqa_logits.mqa_logits(*rec['args'], **rec['kw'])
    require(torch.equal(torch.isneginf(rec['out']), torch.isneginf(want)),
            'prefill MQA logits: -inf at other places than the plain version')
    fin = ~torch.isneginf(want)
    diff, err = compare(rec['out'][fin], want[fin])
    require(diff < TOL, f'prefill MQA logits: calc_diff {diff} against the plain version')
    check_attention(by_kind['attn'], 'prefill')
    log(f'phase 7 prefill: indexer_sparse_attention on the last {rows} rows of a '
        f'{PREFILL_LEN}-token prompt: launches={counts}; MQA logits instance '
        f'{mqa_instance_name(launched)} (ptxas: {MQA_INSTANCES.get(launched, "no report")}); '
        f'calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g}')
    del k, v, q, out, records, by_kind, rec, want, fin
    calls = mqa_calls(seed)
    bq, bkv, bsf, bw, bks, bke = calls['bench']
    got = mqa_logits.mqa_logits(bq, bkv, bw, bks, bke, kv_sf=bsf)
    with plain_versions():
        want = mqa_logits.mqa_logits(bq, bkv, bw, bks, bke, kv_sf=bsf)
    require(torch.equal(torch.isneginf(got), torch.isneginf(want)),
            'bench MQA logits: -inf at other places than the plain version')
    fin = ~torch.isneginf(want)
    bdiff, berr = compare(got[fin], want[fin])
    require(bdiff < TOL, f'bench MQA logits: calc_diff {bdiff} against the plain version')
    log(f'phase 7 bench MQA logits: calc_diff against plain {bdiff:.3e} (limit {TOL}) '
        f'max_abs_err={berr:.4g}')
    del got, want, fin
    entries = {}
    for label, err_, diff_ in (('path', err, diff), ('bench', berr, bdiff)):
        entries[label] = dict(time_mqa(label, calls[label], arch), max_abs_err=err_,
                              check_calc_diff=diff_)
    entries['path']['instance'] = mqa_instance_name(launched)
    entries['bench_fp4'] = check_fp4_prefill(seed, arch, entries['bench'], calls['bench_bf16'])
    return entries, counts


def check_fp4_prefill(seed, arch, e4m3, decoded):
    """fp8_fp4_mqa_logits with FP4 q and kv at the JAX bench's shape (the
    bench inputs re-quantized to FP4): launches, against the plain version,
    the bf16 instance timed on the decoded operands (``decoded``, the
    bench_bf16 call of :func:`mqa_calls`)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    q8, kv8, sf, w, ks, ke = bench_mqa_inputs(seed)
    q4, kv4 = fp4_rows(q8.float()), fp4_rows(kv8.float() * sf[:, None])
    zero_indexer_counts()
    got = dgt.fp8_fp4_mqa_logits(q4, kv4, w, ks, ke)
    torch.cuda.synchronize()
    counts = indexer_counts()
    require(counts == dict(gather=0, paged=0, mqa=1, attn=0, fused=0),
            f'FP4 MQA logits: launches {counts}')
    with plain_versions():
        want = dgt.fp8_fp4_mqa_logits(q4, kv4, w, ks, ke)
    require(torch.equal(torch.isneginf(got), torch.isneginf(want)),
            'FP4 MQA logits: -inf at other places than the plain version')
    fin = ~torch.isneginf(want)
    diff, err = compare(got[fin], want[fin])
    require(diff < TOL, f'FP4 MQA logits: calc_diff {diff} against the plain version')
    del got, want, fin
    timed = time_mqa('bench_bf16', decoded, arch)
    op_ms = bench_kernel(lambda: dgt.fp8_fp4_mqa_logits(q4, kv4, w, ks, ke), iters=5)
    log(f'phase 7 FP4 MQA logits bench [FP4 q and kv decoded to bf16: the bf16 instance]: '
        f'launches={counts}; calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g} against '
        f'the plain version; kernel_ms={timed["ms"]:.4f} (the op with its FP4 decode '
        f'{op_ms:.4f}); the e4m3 instance, same run: {e4m3["ms"]:.4f}')
    return dict(timed, op_ms=op_ms, max_abs_err=err, check_calc_diff=diff,
                launches=counts['mqa'], e4m3_instance_ms=e4m3['ms'])


def bench_mqa_inputs(seed):
    """The JAX bench's prefill shape: q [2048, 64, 128] e4m3, kv [8192, 128]
    e4m3 with its per-token scales, causal windows (bench.py:723-733)."""
    from deepgemm_tpu_torch.utils.math import cast_to_fp8, per_custom_dims_cast_to_fp8
    sq, skv, h, d = MQA_BENCH
    g = torch.Generator(device='cuda').manual_seed(seed + 8)
    q = cast_to_fp8(torch.randn((sq, h, d), generator=g, device='cuda'))
    kv, sf = per_custom_dims_cast_to_fp8(torch.randn((skv, d), generator=g, device='cuda'),
                                         (0,), use_ue8m0=False)
    w = torch.randn((sq, h), generator=g, device='cuda')
    ks = torch.zeros(sq, dtype=torch.int32, device='cuda')
    ke = torch.arange(sq, dtype=torch.int32, device='cuda') + (skv - sq)
    return q, kv, sf, w, ks, ke


def zero_indexer_counts():
    from deepgemm_tpu_torch.kernels import mqa_logits, paged_mqa, sparse_attn
    paged_mqa.launches.update(gather=0, paged=0)
    mqa_logits.launches = sparse_attn.launches = sparse_attn.paged_launches = 0


def indexer_counts():
    from deepgemm_tpu_torch.kernels import mqa_logits, paged_mqa, sparse_attn
    return dict(gather=paged_mqa.launches['gather'], paged=paged_mqa.launches['paged'],
                mqa=mqa_logits.launches, attn=sparse_attn.launches,
                fused=sparse_attn.paged_launches)


def phase_serve(seed, arch):
    """The decode path at full width; see the module docstring. Returns the
    kernel entries' numbers and counts."""
    from deepgemm_tpu_torch.kernels import paged_mqa
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.models.indexer import indexer_sparse_decode
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    requests = list(range(SERVE['max_slots'])) + [LATE['request']]
    records = []

    def hooks(step, engine, tokens):
        return serving_hooks(records, seed, ALL_KINDS if step == 1 else ('topk',))

    # the main path: counts at 0 just before the engine's run, read just after
    zero_indexer_counts()
    engine, outs, slots, seconds, active, prefill_s = serve(seed, requests, hooks)
    counts = indexer_counts()
    launched = getattr(paged_mqa, 'last_instance', None)     # (a tree before it: None)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = dict(gather=SERVE_STEPS, paged=0, mqa=0, attn=SERVE_STEPS, fused=0)
    require(counts == want, f'decode launches {counts}, expected {want}')
    require(launched in PAGED_INSTANCES or not PAGED_INSTANCES,
            f'the decode\'s paged MQA launched {launched}, not one of phase 2\'s instances')
    instance = (f'{mqa_instance_name(launched, "kPaged")} (ptxas: '
                f'{PAGED_INSTANCES.get(launched, "no report")})' if launched else 'not named')
    for key, out in outs.items():
        require(tuple(out.shape) == (SERVE['num_heads'], SERVE['head_dim'])
                and torch.isfinite(out.float()).all().item(), f'output {key} not finite')
    tokens_per_s = sum(active[1:]) / sum(seconds[1:])
    stub_tokens = torch.arange(SERVE['max_slots'], device='cuda', dtype=torch.int32) + 9200
    stub_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_streams(stub_tokens)
        torch.cuda.synchronize()
        stub_ms.append((time.perf_counter() - t0) * 1e3)
    log(f'phase 7 decode: {len(requests)} requests, prompts {PROMPT_RANGE[0]}-{PROMPT_RANGE[1]} '
        f'tokens (prefill {prefill_s:.2f} s in all), {SERVE_STEPS} steps, request '
        f'{LATE["finishes"]} finished and request {LATE["request"]} ({LATE["prompt"]} tokens) '
        f'admitted before step {LATE["step"]}: launches={counts} (per step paged MQA 1, '
        f'attention 1, gather-fused attention 0, MQA logits 0); paged MQA instance {instance}; '
        f'seconds per step '
        f'{[round(s, 5) for s in seconds]} '
        f'(step 1 with the recording of its kernel calls); tokens/s={tokens_per_s:.1f} '
        f'(active slots / step time, steps 2-{SERVE_STEPS}); peak_mem={peak_gb:.2f} GB; '
        f'the stand-in embed_fn alone for {SERVE["max_slots"]} slots, 5 calls, ms '
        f'{[round(t, 4) for t in stub_ms]}')
    by_kind = {}
    for r in records:
        by_kind.setdefault(r['kind'], r)
    paged_errors, zc_errors, zc_launches = check_paged(by_kind['paged'])
    attn_errors = check_attention(by_kind['attn'], 'decode step 1')

    # the compute step twice on the same state: the same bits
    c = engine.cache
    streams = decode_streams(torch.arange(SERVE['max_slots'], device='cuda',
                                          dtype=torch.int32) + 9100)
    compute = lambda: indexer_sparse_decode(
        streams[0][:, None], (c.k_pages, c.v_pages), (c.ik_pages, c.isf_pages),
        streams[1][:, None], streams[2], torch.from_numpy(engine.context_lens).cuda(),
        torch.from_numpy(engine.block_table).cuda(), engine.max_context_len, SERVE['topk'])
    first, second = compute(), compute()
    require(torch.equal(first, second), 'the compute step differs run to run')
    del first, second
    log('phase 7 determinism: the compute step twice on the same state: bitwise equal')

    flat_profile = profile(lambda: engine.step({sid.seq_id: token_id(sid.seq_id, 99)
                                                for sid in engine._slots if sid is not None}),
                           'decode step',
                           f'one step of {sum(s is not None for s in engine._slots)} active '
                           f'slots', host_ops=8)
    timing = time_decode_kernels(by_kind['paged'], engine, arch)
    records = [r for r in records if r['kind'] == 'topk']
    del by_kind
    free_engine(engine)
    del engine, c

    # the same script through the plain versions: their selections and outputs
    plain_records = []
    with plain_versions():
        engine, plain_outs, _, plain_seconds, _, _ = serve(
            seed, requests, lambda step, engine, tokens: serving_hooks(plain_records, seed,
                                                                      ('topk',)))
    free_engine(engine)
    del engine
    sets_k = [r for r in records if r['kind'] == 'topk']
    sets_p = [r for r in plain_records if r['kind'] == 'topk']
    differ, agree_k, agree_p = 0, [], []
    for step in range(1, SERVE_STEPS + 1):
        sk, sp = sets_k[step - 1]['sel'], sets_p[step - 1]['sel']
        for r, slot in slots[step].items():
            if torch.equal(sk[slot], sp[slot]):
                agree_k.append(outs[r, step].float())
                agree_p.append(plain_outs[r, step].float())
            else:
                differ += 1
    free_diff = compare(torch.stack(agree_k), torch.stack(agree_p))[0]
    require(free_diff < TOL, f'decode outputs over agreeing selections: calc_diff {free_diff}')
    log(f'phase 7 kernels vs plain, free-running: {differ} of {len(outs)} (request, step) '
        f'top-{SERVE["topk"]} selections differ from the plain path\'s; over the '
        f'{len(agree_k)} that agree, calc_diff={free_diff:.3e} '
        f'(limit {TOL}); the plain path steps took '
        f'{[round(s, 4) for s in plain_seconds]} s')

    # batch invariance at full width: two requests alone in a fresh 64-slot engine
    engine, solo, solo_slots, _, _, _ = serve(seed, list(INVARIANCE_REQUESTS))
    free_engine(engine)
    del engine
    require(solo.keys() <= outs.keys() and len(solo) > 0, 'batch invariance: no outputs')
    for key, out in solo.items():
        require(torch.equal(out, outs[key]), f'batch invariance: {key} differs alone')
    log(f'phase 7 batch invariance: requests {INVARIANCE_REQUESTS} alone in a fresh '
        f'{SERVE["max_slots"]}-slot engine (slots {solo_slots[SERVE_STEPS]} instead of '
        f'{ {r: slots[SERVE_STEPS][r] for r in INVARIANCE_REQUESTS} }): {len(solo)} outputs, '
        f'bitwise equal')
    return dict(timing=timing, counts=counts, zc_launches=zc_launches, instance=instance,
                selections_differ=[differ, len(outs)],
                errors=dict(paged=paged_errors, zero_copy=zc_errors, attn=attn_errors),
                tokens_per_s=tokens_per_s, peak_gb=peak_gb, outs=outs, slots=slots,
                seconds=seconds, profile=flat_profile)


# Phase 7 under DGT_SPARSE_GATHER=pallas: the same engine script, the decode's
# attention reading its selected rows in place (the gather-fused kernel).
VARLEN_TOKENS = (1, 8)          # tokens a sequence in the varlen check, seeded
SMALL_ROWS = 16                 # rows of a gather-fused timing's small case


def index_select_kernels(prof):
    """(calls, device ms) of the profile's row-gather kernels (what
    ``index_select`` launches: ``vectorized_gather_kernel`` in recent torch,
    ``indexSelect*`` in older ones)."""
    hits = [(calls, us) for name, (us, calls) in prof['by_name'].items()
            if 'indexSelect' in name or 'vectorized_gather_kernel' in name]
    return sum(c for c, _ in hits), sum(u for _, u in hits) / 1e3


def check_fused(rec, arch, seed):
    """The gather-fused kernel (#11) at full shape on step 1's q, tok and
    valid over the current cache: against its plain version on
    ATTN_CHECK_ROWS seeded rows, bitwise equal to index_select + the
    gathered kernel (#10) on all rows; timed beside its bound, its plain
    version, the flat path it replaces (the two index_selects and #10, as
    one) and the library yardstick (the gather and SDPA over the gathered
    rows: two calls, since no one PyTorch call does both)."""
    import torch.nn.functional as F
    from deepgemm_tpu_torch.kernels import sparse_attn
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    q, k_rows, v_rows, tok, valid, scale = (rec[k] for k in ('q', 'k_rows', 'v_rows', 'tok',
                                                              'valid', 'scale'))
    rows, t = tok.shape
    n, h, d = k_rows.shape
    fused = lambda: sparse_attn.sparse_attention_paged(q, k_rows, v_rows, tok, valid, scale)
    got = fused()
    g = torch.Generator().manual_seed(seed)
    sub = torch.randperm(rows, generator=g)[:ATTN_CHECK_ROWS].sort().values.cuda()
    want = sparse_attn.sparse_attention_paged_plain(q[sub], k_rows, v_rows, tok[sub],
                                                    valid[sub], scale)
    diff, err = compare(got[sub], want)
    require(diff < TOL, f'gather-fused attention: calc_diff {diff} against the plain version')
    flat_idx = tok.long().clamp(0, n - 1).reshape(-1)
    gather = lambda: (k_rows.index_select(0, flat_idx).view(rows, t, h, d),
                      v_rows.index_select(0, flat_idx).view(rows, t, h, d))
    k_sel, v_sel = gather()
    require(torch.equal(got, sparse_attn.gathered_attention(q, k_sel, v_sel, valid, scale)),
            'gather-fused attention differs from index_select + the gathered kernel')
    del k_sel, v_sel
    ms = bench_kernel(fused, iters=10)
    flat_ms = bench_kernel(lambda: sparse_attn.gathered_attention(q, *gather(), valid, scale),
                           iters=3)
    plain_ms = bench_kernel(lambda: sparse_attn.sparse_attention_paged_plain(
        q[sub], k_rows, v_rows, tok[sub], valid[sub], scale), iters=2, warmup=1)
    mask = valid[:, None, None, :]

    def library():
        k_sel, v_sel = gather()
        return F.scaled_dot_product_attention(q[:, :, None, :], k_sel.transpose(1, 2),
                                              v_sel.transpose(1, 2), attn_mask=mask,
                                              scale=scale)
    library_ms = bench_kernel(library, iters=3)
    n_valid = int(valid.sum())
    nbytes = 2 * n_valid * h * d * 2 + 2 * q.numel() * 2 + valid.numel() + tok.numel() * 4
    bound = arch.bound_ms(nbytes, 4 * n_valid * h * d, 'bf16')
    log(f'phase 7 gather-fused attention [{rows} rows, topk {t}, h {h}, d {d}; {n_valid} '
        f'valid; the cache {n} rows]: against the plain version on {ATTN_CHECK_ROWS} seeded '
        f'rows {sub.tolist()} calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g}; '
        f'bitwise equal to index_select + the gathered kernel on all {rows} rows; '
        f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} (on {ATTN_CHECK_ROWS} rows) '
        f'flat_path_ms(2 index_select + gathered kernel)={flat_ms:.4f} '
        f'library_ms(2 index_select + F.scaled_dot_product_attention, two calls)='
        f'{library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) GB/s={nbytes / ms / 1e6:.1f}')
    return dict(ms=ms, plain_ms=plain_ms, plain_rows=ATTN_CHECK_ROWS, library_ms=library_ms,
                library='2 index_select + F.scaled_dot_product_attention (two calls)',
                flat_path_ms=flat_ms, bound_ms=bound[0], bound_by=bound[1],
                max_abs_err=err, check_calc_diff=diff, shape=[rows, t, h, d],
                valid_rows=n_valid, bitwise_vs_gather=True)


def fp4_rows(x):
    """f32 rows [.., d] as packed FP4 (per-32 UE8M0 scales, packed int32 a
    row), the recipe of JAX's FP4 indexer tests."""
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp4
    lead, d = x.shape[:-1], x.shape[-1]
    packed, sf = per_token_cast_to_fp4(x.reshape(-1, d), use_ue8m0=True, gran_k=32,
                                       use_packed_ue8m0=True)
    return packed.view(*lead, d // 2), sf.view(lead)


def check_fp4_paged(rec, arch, e4m3_timing):
    """The paged MQA op on step 1's engine shapes with FP4 operands, three
    pairs: FP4 q with the FP4 fused byte cache (the step's e4m3 cache
    re-quantized), FP4 q with the e4m3 cache, e4m3 q with the FP4 cache.
    Each through the op (its own path: counts at 0 before, read after; the
    bf16 instances launch), against its plain version, the two strategies
    bitwise equal; each bf16 instance timed on the decoded operands beside
    the e4m3 instance. Returns the numbers and the launches."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import paged_mqa
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.ops import attention as attn_ops
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    q, kv, sf, w, ctx, bt, max_len = rec['args']
    b, nn, h, d = q.shape
    nb, bkv = kv.shape[:2]
    q4 = fp4_rows(q.float())
    packed, psf = fp4_rows((kv.float() * sf[..., None]).view(-1, d))
    fused4 = torch.cat([packed.view(torch.uint8).view(nb, -1),
                        psf.view(torch.uint8).view(nb, -1)], dim=1).view(nb, bkv, 1, d // 2 + 4)
    del packed, psf
    pairs = {'fp4_q_fp4_cache': (q4, fused4), 'fp4_q_e4m3_cache': (q4, (kv, sf)),
             'e4m3_q_fp4_cache': ((q, None), fused4)}
    hi = paged_mqa.row_bounds(ctx, nn)
    bt32 = bt.int().clamp(0, nb - 1)
    need = int(ctx.clamp(max=max_len).sum())
    out, launches = {}, dict(gather=0, paged=0)
    for label, (qq, cache) in pairs.items():
        args = (qq, cache, w, ctx, bt, None, max_len)
        zero_indexer_counts()
        got = {s: dgt.fp8_fp4_paged_mqa_logits(*args, strategy=s) for s in ('gather', 'paged')}
        torch.cuda.synchronize()
        counts = indexer_counts()
        require(counts == dict(gather=1, paged=1, mqa=0, attn=0, fused=0),
                f'FP4 paged MQA {label}: launches {counts}')
        for s in launches:
            launches[s] += counts[s]
        with plain_versions():
            want = dgt.fp8_fp4_paged_mqa_logits(*args)
        require(torch.equal(torch.isneginf(got['gather']), torch.isneginf(want)),
                f'FP4 paged MQA {label}: -inf at other places than the plain version')
        fin = ~torch.isneginf(want)
        diff, err = compare(got['gather'][fin], want[fin])
        require(diff < TOL, f'FP4 paged MQA {label}: calc_diff {diff} against the plain version')
        require(torch.equal(got['paged'], got['gather']),
                f'FP4 paged MQA {label}: the strategies differ')
        del got, want, fin
        # the instance on the decoded operands, as the op hands them to it
        q_k = attn_ops._decode_fp4_rows(qq[0], qq[1]) if qq[1] is not None else qq[0]
        if isinstance(cache, tuple):
            kv_k, sf_k = cache
        else:
            kv_k = attn_ops._decode_fp4_rows(*attn_ops.split_fused_kv_cache_fp4(cache, d))
            sf_k = torch.ones(kv_k.shape[:2], device='cuda')
        kv_lin, sf_lin = paged_mqa.linearise(kv_k, sf_k, bt32)
        entry = {}
        for name, fn in (('gather', lambda: paged_mqa.paged_mqa_logits_gather(
                              q_k, kv_lin, sf_lin, w, hi, max_len)),
                         ('paged', lambda: paged_mqa.paged_mqa_logits_paged(
                              q_k, kv_k, sf_k, w, hi, bt32, max_len))):
            ms, device = bench_kernel(fn, iters=20), bench_kernel(fn, iters=20, hide_host=True)
            with plain_versions():
                plain_ms = bench_kernel(fn, iters=2, warmup=1)
            kv_bytes = kv_k.element_size()
            nbytes = (need * (d * kv_bytes + 4) + q_k.numel() * q_k.element_size()
                      + w.numel() * 4 + hi.numel() * 4 + b * nn * max_len * 4)
            bound = arch.bound_ms(nbytes, 2 * need * nn * h * d, 'bf16')
            entry[name] = dict(ms=ms, device_ms=device, plain_ms=plain_ms,
                               library_ms=e4m3_timing[name]['library_ms'], bound_ms=bound[0],
                               bound_by=bound[1], max_abs_err=err, check_calc_diff=diff,
                               q=str(q_k.dtype), kv=str(kv_k.dtype),
                               e4m3_instance_ms=e4m3_timing[name]['ms'])
        out[label] = entry
        gather = entry['gather']
        log(f'phase 7 FP4 paged MQA {label} [B={b} next_n={nn} h={h} d={d} max_len={max_len}] '
            f'(q {q_k.dtype}, cache {kv_k.dtype}: the bf16 instance): launches gather 1, paged '
            f'1; calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g} against the plain '
            f'version; strategies bitwise equal; gather entry kernel_ms={gather["ms"]:.4f} '
            f'plain_ms={gather["plain_ms"]:.4f} bound_ms={gather["bound_ms"]:.4f} '
            f'({gather["bound_by"]}); paged entry kernel_ms={entry["paged"]["ms"]:.4f} '
            f'plain_ms={entry["paged"]["plain_ms"]:.4f}; the e4m3 instance, same run: gather '
            f'{e4m3_timing["gather"]["ms"]:.4f}, paged {e4m3_timing["paged"]["ms"]:.4f}')
        del q_k, kv_k, sf_k, kv_lin, sf_lin
    return out, launches


def check_varlen_and_metadata(rec, engine, seed):
    """Varlen pairing at the engine's shape: 64 sequences of VARLEN_TOKENS
    seeded tokens each (a sequence's tokens end at its current context), the
    host form (values read to the host) and the device form (bounds given,
    no host read) bitwise equal to each other and to the padded 2-D call
    they stand for; t_max x 64 heads above one block's 256 q2 rows. Then the
    schedule metadata for the step's context lengths, printed and checked."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import mqa_logits
    kv, sf, max_len = rec['args'][1], rec['args'][2], rec['args'][6]
    h, d = rec['args'][0].shape[2:]
    slots, bkv = SERVE['max_slots'], SERVE['block_kv']
    ctx_now = torch.from_numpy(engine.context_lens).cuda()
    bt_now = torch.from_numpy(engine.block_table).cuda()
    g = torch.Generator().manual_seed(seed + 11)
    counts = torch.randint(VARLEN_TOKENS[0], VARLEN_TOKENS[1] + 1, (slots,), generator=g)
    t_max = int(counts.max())
    idx = torch.repeat_interleave(torch.arange(slots), counts).cuda()
    pos = torch.cat([torch.arange(c) for c in counts.tolist()]).cuda()
    rows = idx.numel()
    gc = torch.Generator(device='cuda').manual_seed(seed + 12)
    q = torch.randn((rows, 1, h, d), generator=gc, device='cuda').to(torch.float8_e4m3fn)
    w = torch.rand((rows, h), generator=gc, device='cuda') * h ** -0.5
    ctx = (ctx_now[idx] - counts.cuda()[idx] + 1 + pos).clamp(min=0).int()
    call = lambda **kw: dgt.fp8_fp4_paged_mqa_logits(
        (q, None), (kv, sf), w, ctx[:, None], bt_now[idx], None, max_len, indices=idx, **kw)
    host, device = call(), call(max_batch=slots, max_tokens_per_seq=t_max)
    q_pad = torch.zeros((slots, t_max, h, d), dtype=torch.uint8, device='cuda')
    q_pad[idx, pos] = q[:, 0].view(torch.uint8)
    w_pad = torch.zeros((slots * t_max, h), device='cuda')
    w_pad[idx * t_max + pos] = w
    ctx_pad = torch.zeros((slots, t_max), dtype=torch.int32, device='cuda')
    ctx_pad[idx, pos] = ctx
    padded = dgt.fp8_fp4_paged_mqa_logits((q_pad.view(torch.float8_e4m3fn), None), (kv, sf),
                                          w_pad, ctx_pad, bt_now, None, max_len)
    torch.cuda.synchronize()
    require(torch.equal(host, device), 'varlen: the host and device forms differ')
    require(torch.equal(host, padded[idx * t_max + pos]),
            'varlen: differs from the padded 2-D call')
    require(torch.isfinite(host[host != float('-inf')]).all().item(), 'varlen: not finite')
    per_group = max(1, 128 // mqa_logits.query_columns(h))
    log(f'phase 7 varlen: {slots} sequences of {counts.tolist()} tokens ({rows} rows, t_max '
        f'{t_max}: a sequence\'s tokens one query tile, in groups of {per_group} queries): host '
        f'form and device form bitwise equal, both bitwise equal to the padded [{slots}, '
        f'{t_max}] 2-D call')
    num_sms = dgt.get_num_sms()
    meta = dgt.get_paged_mqa_logits_metadata(ctx_now, bkv, num_sms)
    segments = int(((ctx_now.long() + bkv - 1) // bkv).sum())
    require(meta.is_cuda and tuple(meta.shape) == (num_sms + 1, 2),
            f'metadata: {tuple(meta.shape)}, expected ({num_sms + 1}, 2)')
    require(torch.equal(meta.cpu(), dgt.get_paged_mqa_logits_metadata(ctx_now.cpu(), bkv,
                                                                       num_sms)),
            'metadata: the CUDA table differs from the CPU one')
    require(meta[-1].tolist() == [slots, 0], f'metadata: end cursor {meta[-1].tolist()}')
    log(f'phase 7 metadata: {num_sms} units over {segments} segments of {bkv} tokens '
        f'(context lengths {ctx_now.tolist()}): {meta.shape[0]} rows (checked), '
        f'{[tuple(r) for r in meta.tolist()]}')


def phase_serve_pallas(seed, arch, flat):
    """The decode path under DGT_SPARSE_GATHER=pallas: a fresh engine through
    the same script (counts at 0 just before, read just after: per step the
    gather-fused attention 1, the gathered one 0, paged MQA 1, MQA logits
    0), each output bitwise equal to the 'flat' run's; step times, tokens/s
    and peak memory beside 'flat''s; the compute step twice bitwise equal;
    a profile of one step (the flat gather's index_select kernels gone);
    the gather-fused kernel at full shape; the FP4 paged pairs; varlen and
    the metadata; batch invariance in a fresh engine."""
    from deepgemm_tpu_torch.models.indexer import indexer_sparse_decode
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    requests = list(range(SERVE['max_slots'])) + [LATE['request']]
    records = []

    def hooks(step, engine, tokens):
        return serving_hooks(records, seed, ('paged', 'fused') if step == 1 else ())

    with env('DGT_SPARSE_GATHER', 'pallas'):
        zero_indexer_counts()
        engine, outs, slots, seconds, active, prefill_s = serve(seed, requests, hooks)
        counts = indexer_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = dict(gather=SERVE_STEPS, paged=0, mqa=0, attn=0, fused=SERVE_STEPS)
        require(counts == want, f'decode launches under pallas {counts}, expected {want}')
        require(slots == flat['slots'] and outs.keys() == flat['outs'].keys(),
                'pallas: other slots or outputs than the flat run')
        for key, out in outs.items():
            require(torch.equal(out, flat['outs'][key]), f'pallas: output {key} differs from flat')
        tokens_per_s = sum(active[1:]) / sum(seconds[1:])
        log(f'phase 7 decode under pallas: the same script, launches={counts} (per step '
            f'gather-fused attention 1, attention 0, paged MQA 1, MQA logits 0); all '
            f'{len(outs)} outputs bitwise equal to the flat run; seconds per step '
            f'{[round(x, 5) for x in seconds]} (flat {[round(x, 5) for x in flat["seconds"]]}); '
            f'tokens/s={tokens_per_s:.1f} (flat {flat["tokens_per_s"]:.1f}); peak_mem='
            f'{peak_gb:.2f} GB (flat {flat["peak_gb"]:.2f} GB); prefill {prefill_s:.2f} s')
        by_kind = {}
        for r in records:
            by_kind.setdefault(r['kind'], r)

        c = engine.cache
        streams = decode_streams(torch.arange(SERVE['max_slots'], device='cuda',
                                              dtype=torch.int32) + 9100)
        compute = lambda: indexer_sparse_decode(
            streams[0][:, None], (c.k_pages, c.v_pages), (c.ik_pages, c.isf_pages),
            streams[1][:, None], streams[2], torch.from_numpy(engine.context_lens).cuda(),
            torch.from_numpy(engine.block_table).cuda(), engine.max_context_len, SERVE['topk'])
        first, second = compute(), compute()
        require(torch.equal(first, second), 'pallas: the compute step differs run to run')
        del first, second
        log('phase 7 determinism under pallas: the compute step twice on the same state: '
            'bitwise equal')
        prof = profile(lambda: engine.step({sid.seq_id: token_id(sid.seq_id, 99)
                                            for sid in engine._slots if sid is not None}),
                       'decode step under pallas',
                       f'one step of {sum(s is not None for s in engine._slots)} active '
                       f'slots', host_ops=8)
        require(prof is not None and flat['profile'] is not None,
                'the profiler saw no device events')
        sel_p, sel_f = index_select_kernels(prof), index_select_kernels(flat['profile'])
        require(sel_p[0] < sel_f[0] and sel_p[1] < 0.05 * sel_f[1],
                f'pallas profile: index_select kernels {sel_p} against flat {sel_f}: the '
                f'flat gather is still there')
        log(f'phase 7 profile flat vs pallas: wall {flat["profile"]["wall_ms"]:.3f} vs '
            f'{prof["wall_ms"]:.3f} ms, device {flat["profile"]["device_ms"]:.3f} vs '
            f'{prof["device_ms"]:.3f} ms; index_select kernels (calls, device ms) {sel_f} vs '
            f'{sel_p}: the flat gather\'s copies gone (what is left is the paged MQA '
            f'linearising gather and small index lookups)')
        fused = check_fused(by_kind['fused'], arch, seed)
        fp4, fp4_launches = check_fp4_paged(by_kind['paged'], arch, flat['timing'])
        check_varlen_and_metadata(by_kind['paged'], engine, seed)
        del by_kind, records, c, streams
        free_engine(engine)
        del engine

        # batch invariance at full width: two requests alone in a fresh engine
        engine, solo, solo_slots, _, _, _ = serve(seed, list(INVARIANCE_REQUESTS))
        free_engine(engine)
        del engine
    require(solo.keys() <= outs.keys() and len(solo) > 0, 'batch invariance: no outputs')
    for key, out in solo.items():
        require(torch.equal(out, outs[key]), f'pallas batch invariance: {key} differs alone')
    log(f'phase 7 batch invariance under pallas: requests {INVARIANCE_REQUESTS} alone in a '
        f'fresh engine: {len(solo)} outputs, bitwise equal')
    return dict(counts=counts, fused=fused, fp4=fp4, fp4_launches=fp4_launches,
                tokens_per_s=tokens_per_s, peak_gb=peak_gb,
                profile=dict(wall_ms=prof['wall_ms'], device_ms=prof['device_ms']))


# Phase 8: the mega MoE forward at DeepSeek-V3 widths (the phase 5 widths,
# 2 of 61 layers) through the fused expert-block kernel, one launch a layer.
MEGA_MODES = {            # instance: (scaled, FP4 weights, fp8 act)
    'bf16': (False, False, False), 'fp8': (True, False, False),
    'fp8_act_fp8': (True, False, True), 'fp4': (True, True, False),
    'fp4_act_fp8': (True, True, True)}
MEGA_UNFUSED_LIMIT = {'0': 1e-3, '1': 1e-4}   # tests/test_mega_moe.py:252-257
MEGA_CAP = 40             # moe_capacity(128 tokens, top-8, 256 experts, factor 8)


@contextlib.contextmanager
def env(name, value):
    before = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if before is None:
            del os.environ[name]
        else:
            os.environ[name] = before


def mega_walk(params, tokens, cfg_fused, cfg_unfused):
    """Layer by layer on the fused path's own states: each layer's fused MoE
    output against its plain version (plain_versions) and against the
    unfused path (masked kernels) on the same input. Returns (per-layer
    (plain diff, unfused diff), the walked logits)."""
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.models.transformer import attention, moe_block, rms_norm
    from deepgemm_tpu_torch.testing import calc_diff
    x = params['embed'][tokens]
    diffs = []
    for layer in params['layers']:
        h = x + attention(rms_norm(x, layer['ln1']), layer['wqkv'], layer['wo'], cfg_fused)
        moe_in = rms_norm(h, layer['ln2'])
        y = moe_block(moe_in, layer, cfg_fused)
        with plain_versions():
            y_plain = moe_block(moe_in, layer, cfg_fused)
        y_unfused = moe_block(moe_in, layer, cfg_unfused)
        require(torch.isfinite(y.float()).all().item(), 'fused MoE output not finite')
        diffs.append((calc_diff(y, y_plain), calc_diff(y, y_unfused)))
        x = h + y
    embed = params['embed'].float()
    return diffs, torch.matmul(rms_norm(x, params['final_norm']).float(), embed.t())


def fp4_blocks(w, experts=16):
    """Per-128x128-block e2m1 codes of bf16 w [E, n, k] in the planar-128
    layout (int8 [E, n, k/2]) and their f32 scales, a few experts at a time."""
    from deepgemm_tpu_torch.utils.math import _quantize_to_fp4_e2m1, pack_fp4_planar
    e, n, k = w.shape
    codes = torch.empty((e, n, k // 2), dtype=torch.int8, device=w.device)
    sf = torch.empty((e, n // 128, k // 128), dtype=torch.float32, device=w.device)
    for e0 in range(0, e, experts):
        wf = w[e0:e0 + experts].float().view(-1, n // 128, 128, k // 128, 128)
        s = wf.abs().amax(dim=(2, 4)).clamp(min=1e-4) / 6.0
        sf[e0:e0 + experts] = s
        codes[e0:e0 + experts] = pack_fp4_planar(
            _quantize_to_fp4_e2m1((wf / s[:, :, None, :, None]).view(-1, n, k)))
        del wf
    return codes, sf


def decode_fp4(w, experts=16):
    from deepgemm_tpu_torch.kernels.fused_moe import decode_fp4_planar
    out = torch.empty((*w.shape[:-1], 2 * w.shape[-1]), dtype=torch.float8_e4m3fn,
                      device=w.device)
    for e0 in range(0, w.shape[0], experts):
        out[e0:e0 + experts] = decode_fp4_planar(w[e0:e0 + experts])
    return out


def mega_modes(w1, w2, gen, arch):
    """The kernel's five instances at one layer's full shapes (E=256,
    cap=40, hidden 7168, intermediate 2048) on the layer's weights and
    seeded slot rows: each against its plain version, twice bitwise, FP4
    bitwise the fp8 instance fed the decoded weights, the packed call
    bitwise the raw one; then each timed beside its bound, its plain
    version, the unfused layer (masked L1, swiglu_apply_weight, masked L2)
    and two bf16 torch.bmm with F.silu between. Returns {mode: numbers}."""
    import torch.nn.functional as F
    from deepgemm_tpu_torch.kernels import fused_moe, grouped
    from deepgemm_tpu_torch.parallel.moe import swiglu_apply_weight
    from deepgemm_tpu_torch.testing import count_bytes
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8, quantize_experts
    e_count, two_i, hidden = w1.shape
    inter, cap = two_i // 2, MEGA_CAP
    x = randn_bf16((e_count, cap, hidden), gen, 1.0)
    rw = torch.rand((e_count, cap), generator=gen, device='cuda')
    xq, xsf = per_token_cast_to_fp8(x.view(-1, hidden), use_ue8m0=False)
    xq, xsf = xq.view(e_count, cap, hidden), xsf.view(e_count, cap, -1)
    full = torch.full((e_count,), cap, dtype=torch.int32, device='cuda')
    flops = 2 * e_count * cap * (two_i * hidden + hidden * inter)
    library_ms = bench_kernel(lambda: torch.bmm(
        (lambda gu: F.silu(gu[..., :inter]) * gu[..., inter:])(
            torch.bmm(x, w1.transpose(1, 2))).to(torch.bfloat16), w2.transpose(1, 2)), iters=3)
    weights = {'bf16': (w1, None, w2, None)}
    weights['fp8'] = (*quantize_experts(w1), *quantize_experts(w2))
    weights['fp4'] = (*fp4_blocks(w1), *fp4_blocks(w2))
    out = {}
    for mode, (scaled, w_fp4, act_fp8) in MEGA_MODES.items():
        a1, s1, a2, s2 = weights['fp4' if w_fp4 else 'fp8' if scaled else 'bf16']
        args = (xq, xsf, rw, a1, s1, a2, s2) if scaled else (x, None, rw, a1, None, a2, None)
        kw = dict(w_fp4=w_fp4, act_fp8=act_fp8, silu_tanh=scaled and not act_fp8)
        kernel = lambda: fused_moe.mega_local(*args, **kw)
        y, again = kernel(), kernel()
        ref = fused_moe.mega_local_plain(*args, **kw)
        torch.cuda.synchronize()
        diff, err = compare(y, ref)
        require(diff < TOL, f'mega {mode}: calc_diff {diff} against the plain version')
        require(torch.equal(y, again), f'mega {mode}: two calls differ')
        checks = ['twice bitwise equal']
        # the weights as e4m3 (FP4 decoded): the fp8 instance's and the unfused layer's
        d1, d2 = (decode_fp4(a1), decode_fp4(a2)) if w_fp4 else (a1, a2)
        if w_fp4:
            y8 = fused_moe.mega_local(xq, xsf, rw, d1, s1, d2, s2, **dict(kw, w_fp4=False))
            torch.cuda.synchronize()
            require(torch.equal(y, y8), f'mega {mode}: FP4 differs from the decoded fp8 weights')
            checks.append('bitwise equal to fp8 fed the decoded weights')
            del y8
        if mode == 'fp8':
            pk = fused_moe.pack_mega_weights(a1, a2, s1, s2, act_fp8=False)
            packed = fused_moe.fused_mega_moe(xq[None], rw[None], send_sf=xsf[None], packed=pk)
            raw = fused_moe.fused_mega_moe(xq[None], rw[None], a1, a2, send_sf=xsf[None],
                                           w1_sf=s1, w2_sf=s2, act_fp8=False)
            torch.cuda.synchronize()
            require(torch.equal(packed, raw) and torch.equal(raw[0], y),
                    'mega fp8: packed, raw and the kernel call differ')
            checks.append('packed bitwise equal to raw')
            del pk, packed, raw
        ms = bench_kernel(kernel, iters=5)
        plain_ms = bench_kernel(lambda: fused_moe.mega_local_plain(*args, **kw), iters=1, warmup=0)

        def unfused():
            if not scaled:
                gu = grouped.masked_gemm(x, d1, full)
                return grouped.masked_gemm(swiglu_apply_weight(gu, rw).to(torch.bfloat16), d2, full)
            gu = grouped.masked_gemm(xq, d1, full, sfa=xsf, sfb=s1)
            act = swiglu_apply_weight(gu, rw).to(torch.bfloat16)
            aq, asf = per_token_cast_to_fp8(act.view(-1, inter), use_ue8m0=False)
            return grouped.masked_gemm(aq.view(e_count, cap, inter), d2, full,
                                       sfa=asf.view(e_count, cap, -1), sfb=s2)
        unfused_ms = bench_kernel(unfused, iters=3)
        del d1, d2
        bound = arch.bound_ms(count_bytes(*args) + 2 * y.numel(), flops, 'fp8' if scaled else 'bf16')
        out[mode] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=err,
                         bound_ms=bound[0], bound_by=bound[1], unfused_ms=unfused_ms,
                         check_calc_diff=diff, shape=[e_count, cap, hidden, inter])
        log(f'phase 8 mode {mode} [E={e_count} cap={cap} H={hidden} I={inter}]: calc_diff={diff:.3e} '
            f'(limit {TOL}) max_abs_err={err:.4g}, {", ".join(checks)}; kernel_ms={ms:.4f} '
            f'plain_ms={plain_ms:.4f} unfused_layer_ms(masked L1 + swiglu_apply_weight + masked '
            f'L2{" on the decoded weights" if w_fp4 else ""})={unfused_ms:.4f} '
            f'library_ms(bf16 torch.bmm, F.silu(gate) * up, torch.bmm)={library_ms:.4f} '
            f'bound_ms={bound[0]:.4f} ({bound[1]}) GB/s={(count_bytes(*args) + 2 * y.numel()) / ms / 1e6:.1f} '
            f'TFLOPS={flops / ms / 1e9:.1f}')
        del y, again, ref
        torch.cuda.empty_cache()
    return out


def phase_mega(seed, arch):
    """The mega MoE forward through the model's entry point; see the module
    docstring. Returns (timing by mode, launches of the main path)."""
    from deepgemm_tpu_torch.kernels import dense, fused_moe, grouped
    from deepgemm_tpu_torch.models.transformer import ModelConfig, forward, init_params
    from deepgemm_tpu_torch.testing import calc_diff
    t0 = time.perf_counter()
    params = init_params(ModelConfig(**V3), seed=seed + 9, device='cuda')
    torch.cuda.synchronize()
    log(f'phase 8 init: {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 1e9:.2f} GB of weights on the card')
    gen = torch.Generator(device='cuda').manual_seed(seed + 10)
    batches = [torch.randint(0, V3['vocab'], BATCH_SHAPE, generator=gen, device='cuda')
               for _ in range(BATCHES)]
    cfg_unfused = ModelConfig(**V3, use_fp8=True, use_kernels=True)
    cfg_fused = ModelConfig(**V3, use_fp8=True, use_kernels=True, use_mega=True,
                            mega_comm='fused')
    layers = V3['num_layers']
    launches = {}
    for act in ('0', '1'):
        kind = 'fp8_act_fp8' if act == '1' else 'fp8'
        with env('DGT_MEGA_ACT_FP8', act):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            # the main path: counts at 0 just before, read just after
            for key in fused_moe.launches:
                fused_moe.launches[key] = 0
            grouped.launches.update(bf16=0, fp8=0)
            dense.launches = 0
            logits, seconds = [], []
            for tokens in batches:
                t0 = time.perf_counter()
                logits.append(forward(params, tokens, cfg_fused))
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
            seen = dict(mega=dict(fused_moe.launches), masked=sum(grouped.launches.values()),
                        dense=dense.launches)
            want = dict(mega=dict({k: 0 for k in fused_moe.launches}, **{kind: layers * BATCHES}),
                        masked=0, dense=0)
            require(seen == want, f'mega forward (act {kind}): launches {seen}, expected {want}')
            launches[kind] = seen['mega'][kind]
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            tokens_per_s = (BATCHES - 1) * BATCH_SHAPE[0] * BATCH_SHAPE[1] / sum(seconds[1:])
            log(f'phase 8 forward mega fused, act {"fp8" if act == "1" else "bf16"}: launches '
                f'{seen} (per forward: mega {layers}, masked 0) tokens/s={tokens_per_s:.1f} '
                f'(batches 2-{BATCHES} of {BATCH_SHAPE}; seconds per batch '
                f'{[round(v, 4) for v in seconds]}, the first with warm-up, fp8 weight '
                f'quantization in every call) peak_mem={peak_gb:.2f} GB')
            limit = MEGA_UNFUSED_LIMIT[act]
            for i, (tokens, lk) in enumerate(zip(batches, logits)):
                require(tuple(lk.shape) == (*BATCH_SHAPE, V3['vocab']), f'logits {tuple(lk.shape)}')
                require(torch.isfinite(lk).all().item(), 'mega forward: logits not finite')
                diffs, walked = mega_walk(params, tokens, cfg_fused, cfg_unfused)
                require(torch.equal(walked, lk), 'mega forward: the walk differs from forward')
                plain_d = [d for d, _ in diffs]
                unfused_d = [d for _, d in diffs]
                require(max(plain_d) < TOL and max(unfused_d) < limit,
                        f'mega act {kind}: per layer against plain {plain_d} (limit {TOL}), '
                        f'against unfused {unfused_d} (limit {limit})')
                log(f'  batch {i}: per layer fused MoE vs plain {[f"{d:.3e}" for d in plain_d]} '
                    f'(limit {TOL}), vs unfused (masked kernels) {[f"{d:.3e}" for d in unfused_d]} '
                    f'(limit {limit}); the walk equals forward bitwise')
            del logits
    profile(lambda: forward(params, batches[0], cfg_fused), 'forward mega fused', 'one [2, 64] batch')

    # the 'xla' comm (2 chunks, which move no bit at one rank): bitwise the
    # unfused forward, through the masked kernel
    cfg_xla = ModelConfig(**V3, use_fp8=True, use_kernels=True, use_mega=True, mega_comm='xla',
                          mega_chunks=2)
    grouped.launches.update(bf16=0, fp8=0)
    for key in fused_moe.launches:
        fused_moe.launches[key] = 0
    l_xla = forward(params, batches[0], cfg_xla)
    torch.cuda.synchronize()
    xla_masked, xla_mega = sum(grouped.launches.values()), sum(fused_moe.launches.values())
    l_unfused = forward(params, batches[0], cfg_unfused)
    torch.cuda.synchronize()
    require(xla_masked == 2 * layers and xla_mega == 0,
            f"mega 'xla': masked launches {xla_masked}, mega launches {xla_mega}; "
            f"expected {2 * layers} (2 a layer) and 0")
    require(torch.equal(l_xla, l_unfused), "mega 'xla' (2 chunks) differs from the unfused forward")
    log(f"phase 8 mega 'xla' comm, 2 chunks: logits bitwise equal to the unfused forward "
        f"(masked launches {xla_masked}, required {2 * layers}: 2 a layer; mega launches "
        f"{xla_mega}, required 0); fused against unfused logits "
        f"calc_diff {calc_diff(forward(params, batches[0], cfg_fused), l_unfused):.3e}")
    del l_xla, l_unfused
    layer0 = params['layers'][0]
    w1, w2 = layer0['w1'], layer0['w2']
    del params, layer0
    torch.cuda.empty_cache()
    timing = mega_modes(w1, w2, gen, arch)
    del w1, w2
    torch.cuda.empty_cache()
    return timing, launches


# Phase 9: the entry points that no model path of the JAX package calls, at
# DeepSeek-V3 widths (hidden 7168, 128 heads, MLA kv_lora_rank 512,
# qk_nope_head_dim 128, qk_rope_head_dim 64, v_head_dim 128). Each entry's
# call is its own path: its kernel's count set to 0 just before, read just
# after.
# The HC prenorm GEMM of manifold-constrained hyper-connections with 4
# residual streams (mHC, DeepSeek, arXiv 2512.24880): k = 4 x 7168, n = 4 +
# 4 + 4 x 4 = 24; a prefill chunk of 4096 tokens unsplit, the engine's 64
# decode slots in 16 k splits (chunks of 1792).
HC_K, HC_N = 4 * 7168, 4 + 4 + 4 * 4
HC_CALLS = ((4096, None), (64, 16))
# MLA's output projection through W_UV (bhr,hdr->bhd) over 4096 tokens, and
# the absorbed W_UK (bhd,hdr->bhr) for the bf16 einsum.
MLA_TOKENS, MLA_HEADS, MLA_RANK, MLA_DIM = 4096, 128, 512, 128
# the skip-head-mid GEMM: per head nope 128 | rope 64 (zero) | v 128
SKIP_M, SKIP_K, SKIP_SPLITS = 4096, 512, (128, 64, 128)
# the dual-B form at the training step's contiguous shapes (phase 6: 256
# experts; L1 n 4096, k 7168; L2 n 7168, k 2048), per-expert rows 0, 128 or
# 256 drawn from --seed
DUAL_EXPERTS, DUAL_SHAPES = 256, (('L1', 4096, 7168), ('L2', 7168, 2048))
FP4_SHAPE = (4096, 4096, 7168)


def timed(kernel, plain, library, plain_iters=1):
    """(kernel ms, plain ms, library ms or None), each L2-flushed."""
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    return (bench_kernel(kernel),
            bench_kernel(plain, iters=plain_iters, warmup=1),
            None if library is None else bench_kernel(library, iters=10))


def plain_of(fn):
    """``fn`` run through the kernels' plain versions."""
    from deepgemm_tpu_torch.kernels.common import plain_versions

    def run():
        with plain_versions():
            return fn()
    return run


def phase_hc(gen, arch):
    """The HC prenorm kernel at the two mHC calls: launches, d and sqr_sum
    against the plain version (TOL and 1e-6, JAX's limits), the split
    partials summed against the unsplit kernel, times. Returns (entries,
    launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import hc_prenorm
    from deepgemm_tpu_torch.testing import calc_diff, count_bytes
    entries, launches = [], 0
    for m, splits in HC_CALLS:
        a = randn_bf16((m, HC_K), gen, 1.0)
        b = torch.randn((HC_N, HC_K), generator=gen, device='cuda') * HC_K ** -0.5
        call = lambda: dgt.tf32_hc_prenorm_gemm(a, b, num_splits=splits)
        hc_prenorm.launches = 0
        d, s = call()
        torch.cuda.synchronize()
        require(hc_prenorm.launches == 1, f'HC prenorm m={m}: {hc_prenorm.launches} launches')
        launches += hc_prenorm.launches
        d_p, s_p = plain_of(call)()
        diff_d, err = compare(d, d_p)
        diff_s, _ = compare(s, s_p)
        require(diff_d < TOL and diff_s < 1e-6,
                f'HC prenorm m={m}: calc_diff d {diff_d}, sqr_sum {diff_s} against the plain version')
        split_diff = None
        if splits:
            whole_d, whole_s = dgt.tf32_hc_prenorm_gemm(a, b)
            split_diff = (calc_diff(d.sum(0), whole_d), calc_diff(s.sum(0), whole_s))
            require(max(split_diff) < TOL, f'HC prenorm: split partials summed {split_diff}')
        count = splits or 1
        a32 = a.float()
        ms, plain_ms, library_ms = timed(
            lambda: hc_prenorm.hc_prenorm_gemm(a, b, count),
            lambda: hc_prenorm.hc_prenorm_gemm_plain(a, b, count),
            lambda: torch.matmul(a32, b.t()), plain_iters=3)
        moved = count_bytes(a, b, d, s)
        bound = arch.bound_ms(moved, 2 * m * HC_N * HC_K + 2 * m * HC_K, 'tf32')
        entries.append(dict(shape=[m, HC_N, HC_K], splits=count,
                            **numbers(ms, plain_ms, library_ms, err, bound)))
        log(f'phase 9 HC prenorm m={m} n={HC_N} k={HC_K} splits={count}: launches 1; calc_diff '
            f'd={diff_d:.3e} (limit {TOL}) sqr_sum={diff_s:.3e} (limit 1e-6) max_abs_err={err:.4g}'
            + (f'; partials summed against unsplit d={split_diff[0]:.3e} sqr={split_diff[1]:.3e}'
               if split_diff else '')
            + f'; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(torch.matmul f32, '
            f'TF32 off, d only)={library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) '
            f'GB/s={moved / ms / 1e6:.1f}')
        del a, b, a32, d, s, d_p, s_p
    torch.cuda.empty_cache()
    return entries, launches


def cast_heads(x):
    """[b, h, r] bf16 -> (e4m3, f32 scales [b, h, ceil(r/128)]): per token and head."""
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8
    q, sf = per_token_cast_to_fp8(x.reshape(-1, x.shape[-1]), use_ue8m0=False)
    return q.view(x.shape), sf.view(*x.shape[:2], -1)


def phase_einsum(gen, arch):
    """fp8_einsum bhr,hdr->bhd (MLA's W_UV) on the masked kernel, one
    launch, G = 128 heads, against its plain version; fp8_bmm with c on the
    f32 instance; the bf16 einsums against f32 torch.bmm of the same
    operands. Returns (einsum entry, f32 entry, launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import grouped
    from deepgemm_tpu_torch.testing import calc_diff, count_bytes
    from deepgemm_tpu_torch.utils.math import per_block_cast_to_fp8
    tokens, h, r, dv = MLA_TOKENS, MLA_HEADS, MLA_RANK, MLA_DIM
    x = randn_bf16((tokens, h, r), gen, 1.0)
    w = randn_bf16((h, dv, r), gen, r ** -0.5)
    x_q, w_q = cast_heads(x), per_block_cast_to_fp8(w, use_ue8m0=False)
    call = lambda: dgt.fp8_einsum('bhr,hdr->bhd', x_q, w_q)
    grouped.launches.update(bf16=0, fp8=0, fp8_f32=0)
    out = call()
    torch.cuda.synchronize()
    counts = dict(grouped.launches)
    require(counts == dict(bf16=0, fp8=1, fp8_f32=0),
            f'fp8_einsum: masked launches {counts}, expected fp8 1')
    out_p = plain_of(call)()
    diff, err = compare(out, out_p)
    require(diff < TOL, f'fp8_einsum: calc_diff {diff} against the plain version')
    quant = calc_diff(out, torch.einsum('bhr,hdr->bhd', x.float(), w.float()))
    require(quant < 1e-3, f'fp8_einsum: calc_diff {quant} against the f32 einsum')
    # the kernel's own operands: heads leading, contiguous
    a_t, sfa_t = (t.transpose(0, 1).contiguous() for t in x_q)
    full = torch.full((h,), tokens, dtype=torch.int32, device='cuda')
    kernel_args = (a_t, w_q[0], full)
    kernel_kw = dict(sfa=sfa_t, sfb=w_q[1])
    ms, plain_ms, library_ms = timed(
        lambda: grouped.masked_gemm(*kernel_args, **kernel_kw),
        lambda: grouped.masked_gemm_plain(*kernel_args, **kernel_kw),
        lambda: torch.einsum('bhr,hdr->bhd', x, w))
    moved = count_bytes(a_t, sfa_t, *w_q, full) + 2 * tokens * h * dv
    flops = 2 * tokens * h * dv * r
    bound = arch.bound_ms(moved, flops, 'fp8')
    einsum_entry = dict(shape=[h, tokens, dv, r], **numbers(ms, plain_ms, library_ms, err, bound))
    log(f'phase 9 fp8_einsum bhr,hdr->bhd b={tokens} h={h} r={r} d={dv}: masked launches '
        f'{counts} (G={h}); calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g} '
        f'vs_f32_einsum={quant:.3e}; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} '
        f'library_ms(torch.einsum bf16)={library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) '
        f'GB/s={moved / ms / 1e6:.1f}')

    # fp8_bmm with c: the promoted sum in f32 (the f32 instance), then + c
    c = torch.randn((h, tokens, dv), generator=gen, device='cuda')
    call = lambda: dgt.fp8_bmm(a_t, sfa_t, *w_q, c=c)
    grouped.launches.update(bf16=0, fp8=0, fp8_f32=0)
    out_c = call()
    torch.cuda.synchronize()
    counts_c = dict(grouped.launches)
    require(counts_c == dict(bf16=0, fp8=0, fp8_f32=1),
            f'fp8_bmm with c: masked launches {counts_c}, expected f32 1')
    out_cp = plain_of(call)()
    diff_c, err_c = compare(out_c, out_cp)
    require(diff_c < TOL, f'fp8_bmm with c: calc_diff {diff_c} against the plain version')
    f32_kw = dict(kernel_kw, out_dtype=torch.float32)
    x32, w32 = x.float(), w.float()
    ms, plain_ms, library_ms = timed(
        lambda: grouped.masked_gemm(*kernel_args, **f32_kw),
        lambda: grouped.masked_gemm_plain(*kernel_args, **f32_kw),
        lambda: torch.einsum('bhr,hdr->hbd', x32, w32))
    moved_f32 = moved + 2 * tokens * h * dv
    bound = arch.bound_ms(moved_f32, flops, 'fp8')
    f32_entry = dict(shape=[h, tokens, dv, r], **numbers(ms, plain_ms, library_ms, err_c, bound))
    log(f'phase 9 fp8_bmm with c (the masked kernel\'s f32 instance): fp8_f32 launches 1; '
        f'calc_diff={diff_c:.3e} (limit {TOL}) max_abs_err={err_c:.4g}; kernel_ms={ms:.4f} '
        f'plain_ms={plain_ms:.4f} library_ms(torch.einsum f32, TF32 off)={library_ms:.4f} '
        f'bound_ms={bound[0]:.4f} ({bound[1]})')
    del out, out_p, out_c, out_cp, c, a_t, sfa_t, x32, w32

    # the bf16 einsums (torch calls, as JAX leaves them to XLA): held to f32
    # torch.bmm of the same operands
    q_nope = randn_bf16((tokens, h, dv), gen, 1.0)
    w_uk = randn_bf16((h, dv, r), gen, dv ** -0.5)
    checks = {}
    out = dgt.einsum('bhr,hdr->bhd', x, w)
    ref = torch.bmm(x.float().transpose(0, 1), w.float().transpose(1, 2)).transpose(0, 1)
    checks['bhr,hdr->bhd'] = calc_diff(out, ref)
    out = dgt.einsum('bhd,hdr->bhr', q_nope, w_uk)
    ref = torch.bmm(q_nope.float().transpose(0, 1), w_uk.float()).transpose(0, 1)
    checks['bhd,hdr->bhr'] = calc_diff(out, ref)
    # a weight-gradient-shaped reduce over 4 chunks of 1024 tokens into f32 c
    xa = randn_bf16((4, MLA_RANK, 1024), gen, 1.0)
    xb = randn_bf16((4, 7168, 1024), gen, 1.0)
    c = torch.randn((MLA_RANK, 7168), generator=gen, device='cuda')
    out = dgt.einsum('bmk,bnk->mn', xa, xb, d=c, c=c)
    ref = torch.bmm(xa.float(), xb.float().transpose(1, 2)).sum(0) + c
    checks['bmk,bnk->mn (f32 out, + c)'] = calc_diff(out, ref)
    require(out.dtype == torch.float32 and max(checks.values()) < TOL,
            f'bf16 einsum against f32 torch.bmm: {checks}')
    log(f'phase 9 bf16 einsum (torch calls, no kernel) against f32 torch.bmm: '
        + ', '.join(f'{k} calc_diff={v:.3e}' for k, v in checks.items()) + f' (limit {TOL})')
    del x, w, x_q, w_q, q_nope, w_uk, xa, xb, c, out, ref
    torch.cuda.empty_cache()
    return einsum_entry, f32_entry, dict(einsum=counts['fp8'], bmm_f32=counts_c['fp8_f32'])


def phase_skip_head_mid(gen, arch):
    """fp8_gemm_nt_skip_head_mid: one dense launch, the mid columns exactly
    zero, the rest bitwise the dense kernel's, the whole against the plain
    version. Returns (entry, launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.testing import count_bytes
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import per_block_cast_to_fp8, per_token_cast_to_fp8
    left, mid, right = SKIP_SPLITS
    m, k, heads = SKIP_M, SKIP_K, MLA_HEADS
    n = heads * (left + right)
    a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
    a_q = per_token_cast_to_fp8(a, use_ue8m0=False)
    b_q = per_block_cast_to_fp8(b, use_ue8m0=False)
    call = lambda: dgt.fp8_gemm_nt_skip_head_mid(a_q, b_q, head_splits=SKIP_SPLITS)
    dense.launches = 0
    out = call()
    torch.cuda.synchronize()
    launches = dense.launches
    require(launches == 1, f'skip-head-mid: {launches} dense launches')
    kernel = lambda: dense.dense_fp8_gemm_nt(a_q[0], b_q[0], a_q[1], b_q[1])
    narrow = kernel()
    wide = out.view(m, heads, left + mid + right)
    narrow3 = narrow.view(m, heads, left + right)
    require(tuple(out.shape) == (m, heads * (left + mid + right))
            and not wide[:, :, left:left + mid].any().item(),
            'skip-head-mid: the mid columns are not exactly zero')
    require(torch.equal(wide[:, :, :left], narrow3[:, :, :left])
            and torch.equal(wide[:, :, left + mid:], narrow3[:, :, left:]),
            'skip-head-mid: the head columns differ from the dense kernel')
    out_p = plain_of(call)()
    diff, err = compare(out, out_p)
    require(diff < TOL, f'skip-head-mid: calc_diff {diff} against the plain version')
    ms, plain_ms, library_ms = timed(call, plain_of(call), lambda: torch.matmul(a, b.t()))
    kernel_ms = bench_kernel(kernel)
    moved = count_bytes(*a_q, *b_q) + 2 * m * heads * (left + mid + right)
    bound = arch.bound_ms(moved, 2 * m * n * k, 'fp8')
    entry = dict(shape=[m, n, k], head_splits=list(SKIP_SPLITS), dense_kernel_ms=kernel_ms,
                 **numbers(ms, plain_ms, library_ms, err, bound))
    log(f'phase 9 fp8_gemm_nt_skip_head_mid m={m} k={k} heads={heads} splits={SKIP_SPLITS} '
        f'(n={n}, out {out.shape[1]} columns): dense launches 1; mid exactly zero, heads '
        f'bitwise the dense kernel; calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g}; '
        f'op_ms={ms:.4f} (dense kernel {kernel_ms:.4f}) plain_ms={plain_ms:.4f} '
        f'library_ms(torch.matmul bf16, narrow)={library_ms:.4f} bound_ms={bound[0]:.4f} '
        f'({bound[1]})')
    del a, b, a_q, b_q, out, out_p, narrow
    torch.cuda.empty_cache()
    return entry, launches


def dual_layout(seed):
    """Per-expert rows 0, 128 or 256 drawn from ``seed`` (a routed batch:
    some experts get no token), the total a multiple of 256; at least a
    quarter of the groups start on 128 mod 256. Returns per-row ids [m]."""
    gen = torch.Generator().manual_seed(seed)
    counts = torch.randint(0, 3, (DUAL_EXPERTS,), generator=gen) * 128
    if counts.sum() % 256:
        counts[-1] += 128
    starts = counts.cumsum(0) - counts
    odd = int((starts % 256 == 128).sum())
    require(odd * 4 >= DUAL_EXPERTS, f'dual-B layout: {odd} of {DUAL_EXPERTS} starts at 128 mod 256')
    ids = torch.repeat_interleave(torch.arange(DUAL_EXPERTS, dtype=torch.int32), counts)
    return ids.cuda(), counts, odd


def phase_dual_b(seed, gen, arch):
    """The dual-B form under DGT_GROUPED_DUAL_B=1 at the training step's
    contiguous shapes on a seeded uneven layout, fp8 and bf16: its own
    launch count (by form: the wgmma body's dual item) with the contiguous
    kernel's unchanged, bitwise the contiguous kernel on the same layout,
    against its plain version, times beside the contiguous kernel's.
    Returns ({kind: entries}, {kind: launches})."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import grouped
    from deepgemm_tpu_torch.testing import calc_diff, count_bytes
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8, quantize_experts
    ids, counts, odd = dual_layout(seed)
    ends = counts.cumsum(0).to(torch.int32).cuda()
    m = ids.numel()
    live_experts = int((counts > 0).sum())
    straddles = int(sum(1 for s in (counts.cumsum(0) - counts).tolist()
                        if s % 256 == 128 and s < m))
    entries, launches = {'fp8': [], 'bf16': []}, {'fp8': 0, 'bf16': 0}
    for label, n, k in DUAL_SHAPES:
        a = randn_bf16((m, k), gen, 1.0)
        b = randn_bf16((DUAL_EXPERTS, n, k), gen, k ** -0.5)
        aq, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
        bq, sfb = quantize_experts(b)
        cases = (('fp8', (aq, bq), dict(sfa=sfa, sfb=sfb),
                  lambda: dgt.m_grouped_fp8_gemm_nt_contiguous((aq, sfa), (bq, sfb),
                                                               grouped_layout=ids)),
                 ('bf16', (a, b), {},
                  lambda: dgt.m_grouped_bf16_gemm_nt_contiguous(a, b, grouped_layout=ids)))
        for kind, ops, kw, op in cases:
            grouped.dual_b_launches.update(bf16=0, fp8=0)
            grouped.contiguous_form_launches.clear()
            before = dict(grouped.contiguous_launches)
            with env('DGT_GROUPED_DUAL_B', '1'):
                d = op()
            torch.cuda.synchronize()
            seen = dict(grouped.dual_b_launches)
            forms = dict(grouped.contiguous_form_launches)
            require(seen[kind] == 1 and sum(seen.values()) == 1
                    and grouped.contiguous_launches == before
                    and forms == {grouped.contiguous_form(kind, 'dual', 256): 1},
                    f'dual-B {kind} {label}: launches {seen} (by form {forms}), contiguous '
                    f'kernel {grouped.contiguous_launches} (before {before})')
            launches[kind] += seen[kind]
            d3 = grouped.contiguous_gemm(*ops, ids, **kw)
            torch.cuda.synchronize()
            require(torch.equal(d, d3), f'dual-B {kind} {label}: not bitwise the contiguous kernel')
            d_p = grouped.contiguous_dual_gemm_plain(*ops, ids, **kw)
            diff, err = compare(d, d_p)
            require(diff < TOL, f'dual-B {kind} {label}: calc_diff {diff} against the plain version')
            library = None
            if kind == 'bf16':
                # one torch call of the same function: d[m] = a[m] B[group(m)]^T
                # over the same uneven groups (offsets: the groups' end rows)
                library = lambda: torch._grouped_mm(a, b.transpose(1, 2), offs=ends)
                lib_diff = calc_diff(library(), d)
                require(lib_diff < 1e-4, f'dual-B {kind} {label}: torch._grouped_mm is '
                        f'{lib_diff} from the kernel')
            ms, plain_ms, library_ms = timed(
                lambda: grouped.contiguous_dual_gemm(*ops, ids, **kw),
                lambda: grouped.contiguous_dual_gemm_plain(*ops, ids, **kw), library)
            ms3 = bench_kernel(lambda: grouped.contiguous_gemm(*ops, ids, **kw))
            b_live = ops[1].numel() // DUAL_EXPERTS * live_experts * ops[1].element_size()
            sfb_live = 0 if not kw else kw['sfb'].numel() // DUAL_EXPERTS * live_experts * 4
            moved = count_bytes(ops[0], kw.get('sfa'), ids) + b_live + sfb_live + 2 * m * n
            bound = arch.bound_ms(moved, 2 * m * n * k, kind)
            entries[kind].append(dict(shape=[m, n, k, DUAL_EXPERTS], label=label,
                                      contiguous_ms=ms3, forms=forms,
                                      **numbers(ms, plain_ms, library_ms, err, bound)))
            log(f'phase 9 dual-B {kind} {label} m={m} n={n} k={k} ({live_experts} of '
                f'{DUAL_EXPERTS} experts with rows, {odd} groups starting at 128 mod 256, '
                f'{straddles} straddling tiles): dual-B launches 1 ({forms}), contiguous kernel 0; '
                f'bitwise the contiguous kernel; calc_diff={diff:.3e} (limit {TOL}) '
                f'max_abs_err={err:.4g}; kernel_ms={ms:.4f} (contiguous kernel {ms3:.4f}) '
                f'plain_ms={plain_ms:.4f} '
                + (f'library_ms(torch._grouped_mm bf16)={library_ms:.4f} (calc_diff from the '
                   f'kernel {lib_diff:.3e}) ' if library else
                   'library_ms=null (torch._scaled_grouped_mm takes row-wise scales, not '
                   '1x128 / 128x128 block scales) ')
                + f'bound_ms={bound[0]:.4f} ({bound[1]})')
            del d, d3, d_p
        del a, b, aq, sfa, bq, sfb
        torch.cuda.empty_cache()
    return entries, launches


def phase_fp4_fold(gen, arch):
    """fp8_fp4_gemm_nt with a packed FP4 B (the library's default gran 128):
    one dense launch, against the op's plain route (JAX's bf16 fold), bitwise
    the e4m3 dense kernel fed the decoded codes and per-row scales, timed.
    Returns (entry, launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.testing import count_bytes
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import (decode_fp4_rows, per_token_cast_to_fp4,
                                               per_token_cast_to_fp8)
    m, n, k = FP4_SHAPE
    a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
    a_q = per_token_cast_to_fp8(a, use_ue8m0=False)
    b4 = per_token_cast_to_fp4(b, use_ue8m0=True)
    call = lambda: dgt.fp8_fp4_gemm_nt(a_q, b4)
    dense.launches = 0
    d = call()
    torch.cuda.synchronize()
    launches = dense.launches
    require(launches == 1, f'FP4 fold: {launches} dense launches')
    d_p = plain_of(call)()
    diff, err = compare(d, d_p)
    require(diff < TOL, f'FP4 fold: calc_diff {diff} against the plain route (bf16 fold)')
    codes = decode_fp4_rows(b4[0], None, 128).to(torch.float8_e4m3fn)
    kernel = lambda: dense.dense_fp8_gemm_nt(a_q[0], codes, a_q[1], b4[1], gran_n=1)
    require(torch.equal(d, kernel()), 'FP4 fold: not bitwise the e4m3 kernel on the decoded codes')
    ms, plain_ms, library_ms = timed(call, plain_of(call), lambda: torch.matmul(a, b.t()))
    kernel_ms = bench_kernel(kernel)
    moved = count_bytes(*a_q, *b4) + 2 * m * n
    bound = arch.bound_ms(moved, 2 * m * n * k, 'fp8')
    entry = dict(shape=[m, n, k], dense_kernel_ms=kernel_ms,
                 **numbers(ms, plain_ms, library_ms, err, bound))
    log(f'phase 9 FP4 fold m={m} n={n} k={k} (packed e2m1 B, UE8M0 scales per 128): dense '
        f'launches 1; calc_diff={diff:.3e} against the bf16 fold (limit {TOL}) '
        f'max_abs_err={err:.4g}; bitwise the e4m3 kernel on the decoded codes; op_ms={ms:.4f} '
        f'(decode + kernel; the kernel alone {kernel_ms:.4f}) plain_ms={plain_ms:.4f} '
        f'library_ms(torch.matmul bf16)={library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]})')
    del a, b, a_q, b4, d, d_p, codes
    torch.cuda.empty_cache()
    return entry, launches


def phase_entry_points(seed, gen, arch):
    """Phase 9: returns its kernels' JSON rows."""
    hc, hc_launches = phase_hc(gen, arch)
    einsum_entry, f32_entry, masked_launches = phase_einsum(gen, arch)
    skip, skip_launches = phase_skip_head_mid(gen, arch)
    dual, dual_launches = phase_dual_b(seed, gen, arch)
    fp4, fp4_launches = phase_fp4_fold(gen, arch)

    def row(name, source, replaces, launches, entries, **extra):
        return dict(name=name, route='cuda', source=f'deepgemm_tpu_torch/csrc/{source}',
                    replaces=replaces, launches=launches, **summed(entries),
                    shapes=entries, **extra)

    return [
        row('hc_prenorm_gemm', 'hc_prenorm.cu', 'deepgemm_tpu/kernels/hc_prenorm.py:89',
            hc_launches, hc),
        row('masked_grouped_gemm_fp8_einsum', 'masked.cu', 'deepgemm_tpu/kernels/grouped.py:576',
            masked_launches['einsum'], [einsum_entry]),
        row('masked_grouped_gemm_fp8_f32', 'masked.cu', 'deepgemm_tpu/kernels/grouped.py:576',
            masked_launches['bmm_f32'], [f32_entry]),
        row('dense_fp8_gemm_nt_skip_head_mid', 'dense.cu', 'deepgemm_tpu/kernels/dense.py:291',
            skip_launches, [skip]),
        *(row(f'contiguous_dual_b_gemm_{kind}', 'contiguous.cu',
              'deepgemm_tpu/kernels/grouped.py:401', dual_launches[kind], dual[kind],
              design=f'{CONTIGUOUS_DESIGN}; 256 x 64 items, a 128-row half a warpgroup')
          for kind in ('fp8', 'bf16')),
        row('dense_fp8_gemm_nt_fp4_fold', 'dense.cu', 'deepgemm_tpu/kernels/dense.py:291',
            fp4_launches, [fp4]),
    ]


# Phase 10: the rest of the one-card GEMM surface, entry points no model path
# calls, at DeepSeek-V3 widths, each call its own path (its form's count 0
# just before, read just after): the dense NN/TN/TT layouts at phase 3's
# shapes, C accumulation, packed-UE8M0 scales ('dequant', and 'promote'
# pinned) at 4096 x 4096 x 7168 and phase 3's decode shape, planar FP4 B
# decoded in the kernel at the expert L2 width (n 7168, k 2048) for a decode
# batch, a small and a large prefill, FP4 at scale granularity 32 (the mixed
# 'promote' form; with packed A scales the mixed 'dequant' form; two FP4
# operands bf16 x bf16), the NN contiguous grouped GEMM on phase 9's layout,
# and the flattened NT k-grouped GEMM at the training step's L2 wgrad shape.
# The forms on bf16 products are bound at the bf16 rate (the fp8 rate's
# figure beside it).
# The two GEMM bodies the kernels JSON line names.
HOPPER_DESIGN = ('wgmma e4m3 m64n128k32 from TMA-fed 128-byte-swizzled stages, warp-specialised '
                 'persistent grid, f32 promotion per 128-deep block, TMA-store epilogue '
                 '(csrc/gemm_sm90.cuh)')
WIDEN_DESIGN = ('wgmma bf16 m64nNk16 (N 128, or 64 where wider tiles would leave SMs idle) from '
                'TMA-fed 128-byte-swizzled stages, warp-specialised '
                'persistent grid: e4m3 A widened into the register operand, e4m3 B widened into '
                'one of two bf16 tiles by the consumers a stage ahead, TMA-store epilogue '
                '(csrc/gemm_sm90.cuh widen_kernel)')
CONTIGUOUS_DESIGN = ('wgmma (e4m3 m64nNk32 with the f32 promotion, or bf16 m64nNk16) from '
                     'TMA-fed 128-byte-swizzled stages over (row tile, column tile) items, the '
                     'group from tile_gid in device memory, B through a 3-D tensor map '
                     '(csrc/gemm_sm90.cuh)')
MASKED_DESIGN = ('wgmma m64n128k16 on bf16 products (e4m3 widened exactly to bf16, A into the '
                 'register operand, B into one of two bf16 tiles a stage ahead; each 128-deep '
                 'block promoted as (p * sfb) * sfa) from TMA-fed 128-byte-swizzled stages (a '
                 'ring of up to 3) over (group, row tile, column tile) items, an item at or past '
                 'masked_m skipped before any load, 64-row tiles where max_m <= 64, else 128 '
                 '(csrc/gemm_sm90.cuh widen_body)')
DISPATCH_DESIGN = ('one-sided pushes into an expert-major receive region, then widen_body\'s '
                   'masked items over each expert\'s D x cap received rows as one group (row '
                   'tiles across slabs), (expert, column tile, row tile) items, the producer '
                   'lane waiting for the slabs an item reads (csrc/mega_ep.cu)')
MQA_DESIGN = ('wgmma (e4m3 m64n128k32, or bf16 m64n128k16) with kv rows on M and the query '
              'heads on N, 128-row kv stages by TMA, two consumer warpgroups in turns, ReLU, '
              'weights and the head sum in registers (csrc/mqa_sm90.cuh)')
PAGED_DESIGN = ('csrc/mqa_sm90.cuh\'s body, #7\'s (Source::kPaged: e4m3 widened exactly to '
                'bf16): a batch row\'s tokens one query tile, items of every num_runs-th stage '
                'of a group, producer warps readying items (the block table turned into each '
                'stage\'s page pieces; q, widened by cp.async chunks) and issuing a TMA box a '
                'piece')
LAYOUTS = ('nn', 'tn', 'tt')
PACKED_SHAPES = ((4096, 4096, 7168), (128, 4096, 7168))   # the second is phase 3's decode shape
PLANAR_N, PLANAR_K, PLANAR_MS = 7168, 2048, (16, 128, 4096)
KG_GROUPS, KG_ROWS, KG_M, KG_N = 256, 128, 7168, 2048     # the L2 wgrad: dw2 [256, 7168, 2048]


def t8(x):
    """An e4m3 matrix transposed into a new contiguous tensor."""
    return x.view(torch.uint8).t().contiguous().view(x.dtype)


def counted(call, form):
    """Run ``call`` with the dense counts at 0; require one launch, of ``form``."""
    from deepgemm_tpu_torch.kernels import dense
    dense.launches = 0
    dense.form_launches.clear()
    out = call()
    torch.cuda.synchronize()
    seen = dict(dense.form_launches)
    require(seen == {form: 1} and dense.launches == 1, f'{form}: dense launches {seen}')
    return out


def dense_bound(arch, m, n, k, *tensors, out_bytes=2, rate='fp8'):
    from deepgemm_tpu_torch.testing import count_bytes
    return arch.bound_ms(count_bytes(*tensors) + out_bytes * m * n, 2 * m * n * k, rate)


def bf16_bound(arch, m, n, k, *tensors):
    """The forms on bf16 products: their bound at the bf16 rate, and the
    same work at the fp8 rate beside it (the extra key bound_fp8_ms)."""
    return (dense_bound(arch, m, n, k, *tensors, rate='bf16'),
            dense_bound(arch, m, n, k, *tensors)[0])


def phase_layouts(gen, arch):
    """fp8 NN, TN and TT through the ops at phase 3's shapes: one launch of
    the layout's form, bitwise the NT kernel on the transposed operands,
    against the plain version, timed beside a bf16 torch.matmul on the same
    layout. Returns ({layout: entries}, {layout: launches})."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    entries, launches = {l: [] for l in LAYOUTS}, {l: 0 for l in LAYOUTS}
    for m, n, k in DENSE_SHAPES:
        a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
        aq, sfa = dgt.per_token_cast_to_fp8(a, use_ue8m0=False)
        bq, sfb = dgt.per_block_cast_to_fp8(b, use_ue8m0=False)
        d_nt = dense.dense_fp8_gemm_nt(aq, bq, sfa, sfb)
        a_t, b_t, sfa_t, sfb_t = t8(aq), t8(bq), sfa.t().contiguous(), sfb.t().contiguous()
        a_bt, b_bt = a.t().contiguous(), b.t().contiguous()
        for layout in LAYOUTS:
            a_mn, b_mn = layout[0] == 't', layout[1] == 'n'
            pa = (a_t, sfa_t) if a_mn else (aq, sfa)
            pb = (b_t, sfb_t) if b_mn else (bq, sfb)
            op = getattr(dgt, f'fp8_gemm_{layout}')
            d = counted(lambda: op(pa, pb), f'promote_{layout}')
            launches[layout] += 1
            require(torch.equal(d, d_nt), f'{layout} {m}x{n}x{k}: not bitwise the NT kernel '
                    f'on the transposed operands')
            ka, kb = (a_t if a_mn else aq), (b_t if b_mn else bq)
            kernel = lambda: dense.dense_gemm(ka, kb, sfa, sfb, a_mn=a_mn, b_mn=b_mn)
            plain = lambda: dense.dense_gemm_plain(ka, kb, sfa, sfb, a_mn=a_mn, b_mn=b_mn)
            diff, err = compare(d, plain())
            require(diff < TOL, f'{layout} {m}x{n}x{k}: calc_diff {diff} against the plain version')
            la = a_bt.t() if a_mn else a
            lb = b_bt if b_mn else b.t()
            ms, plain_ms, library_ms = timed(kernel, plain, lambda: torch.matmul(la, lb))
            bound = dense_bound(arch, m, n, k, aq, bq, sfa, sfb)
            entries[layout].append(dict(shape=[m, n, k], **numbers(ms, plain_ms, library_ms,
                                                                   err, bound)))
            log(f'phase 10 dense {layout} m={m} n={n} k={k}: launches 1 ({layout}); bitwise NT on '
                f'the transposes; calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g}; '
                f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(torch.matmul bf16, '
                f'{layout})={library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) '
                f'TFLOPS={2 * m * n * k / ms / 1e9:.1f}')
        del a, b, aq, bq, a_t, b_t, a_bt, b_bt, d_nt
    torch.cuda.empty_cache()
    return entries, launches


def phase_c(gen, arch):
    """C accumulation at 4096^3: f32 and bf16 outputs, and the wgrad recipe
    (1, 1, 128) with d = c = c; in f32 bitwise the kernel's sum without c
    plus c. Returns (entries, launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    m, n, k = DENSE_SHAPES[0]
    a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
    aq, sfa = dgt.per_token_cast_to_fp8(a, use_ue8m0=False)
    c = torch.randn((m, n), generator=gen, device='cuda') * 32
    c16 = c.to(torch.bfloat16)
    a32, b32 = a.float(), b.float()
    entries, launches = [], 0
    for label, recipe, out in (('f32', (1, 128, 128), torch.float32),
                               ('bf16', (1, 128, 128), torch.bfloat16),
                               ('wgrad f32', (1, 1, 128), torch.float32)):
        cast = dgt.per_token_cast_to_fp8 if recipe[1] == 1 else dgt.per_block_cast_to_fp8
        bq, sfb = cast(b, use_ue8m0=False)
        d_tmpl = c if label.startswith('wgrad') else out
        d = counted(lambda: dgt.fp8_gemm_nt((aq, sfa), (bq, sfb), d=d_tmpl, c=c, recipe=recipe),
                    'promote_nt+c')
        launches += 1
        sum32 = dense.dense_gemm(aq, bq, sfa, sfb, gran_n=recipe[1], out_dtype=torch.float32)
        require(torch.equal(d, (sum32 + c).to(out)), f'C {label}: not the f32 sum plus c')
        kw = dict(c=c, gran_n=recipe[1], out_dtype=out)
        kernel = lambda: dense.dense_gemm(aq, bq, sfa, sfb, **kw)
        plain = lambda: dense.dense_gemm_plain(aq, bq, sfa, sfb, **kw)
        diff, err = compare(d, plain())
        require(diff < TOL, f'C {label}: calc_diff {diff} against the plain version')
        library = ((lambda: torch.addmm(c, a32, b32.t())) if out == torch.float32
                   else (lambda: torch.addmm(c16, a, b.t())))
        ms, plain_ms, library_ms = timed(kernel, plain, library)
        bound = dense_bound(arch, m, n, k, aq, bq, sfa, sfb, c,
                            out_bytes=torch.empty((), dtype=out).element_size())
        entries.append(dict(shape=[m, n, k], case=label, **numbers(ms, plain_ms, library_ms,
                                                                   err, bound)))
        log(f'phase 10 C {label} recipe={recipe} m={m} n={n} k={k}: launches 1 (+c); bitwise '
            f'the f32 sum plus c; calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g}; '
            f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms(torch.addmm '
            f'{"f32, TF32 off" if out == torch.float32 else "bf16"})={library_ms:.4f} '
            f'bound_ms={bound[0]:.4f} ({bound[1]})')
    del a, b, aq, bq, c, c16, a32, b32, d, sum32
    torch.cuda.empty_cache()
    return entries, launches


def phase_packed(gen, arch):
    """Packed-UE8M0 scales at 4096 x 4096 x 7168 and at phase 3's decode
    shape (128 x 4096 x 7168), recipes (1, 1, 128) and (1, 128, 128):
    'dequant' (the default) and 'promote' pinned, each one launch of its
    form, against its plain version and each other; both timed. Returns
    (entries, launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.ops import sf_layout
    from deepgemm_tpu_torch.runtime.config import runtime
    entries, launches = [], 0
    for m, n, k in PACKED_SHAPES:
        a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
        aq, sfa_p = dgt.per_token_cast_to_fp8(a, use_ue8m0=True, use_packed_ue8m0=True)
        sfa = sf_layout.transform_sfa(sfa_p, m, k, 128)
        for recipe in ((1, 1, 128), (1, 128, 128)):
            if recipe[1] == 1:
                bq, sfb_p = dgt.per_token_cast_to_fp8(b, use_ue8m0=True, use_packed_ue8m0=True)
            else:
                bq, sfb32 = dgt.per_block_cast_to_fp8(b, use_ue8m0=True)
                sfb_p = sf_layout.get_mn_major_tma_aligned_packed_ue8m0_tensor(sfb32)
            sfb = sf_layout.transform_sfb(sfb_p, n, k, recipe[1:])
            call = lambda: dgt.fp8_gemm_nt((aq, sfa_p), (bq, sfb_p), recipe=recipe)
            require(runtime().force_scale_strategy is None, 'the scale strategy is pinned')
            d = counted(call, 'dequant_nt')
            launches += 1
            runtime().force_scale_strategy = 'promote'
            try:
                d_promote = counted(call, 'promote_nt')
            finally:
                runtime().force_scale_strategy = None
            kw = dict(gran_n=recipe[1])
            kernel = lambda: dense.dense_gemm(aq, bq, sfa, sfb, strategy='dequant', **kw)
            plain = lambda: dense.dense_gemm_plain(aq, bq, sfa, sfb, strategy='dequant', **kw)
            require(torch.equal(d, kernel()), f'packed {recipe}: the op is not the kernel call')
            diff, err = compare(d, plain())
            require(diff < TOL, f'packed {recipe} m={m}: dequant calc_diff {diff} against the '
                    f'plain version')
            vs_promote = compare(d, d_promote)[0]
            require(vs_promote < TOL, f'packed {recipe} m={m}: dequant {vs_promote} from promote')
            promote_plain = compare(d_promote, dense.dense_gemm_plain(aq, bq, sfa, sfb, **kw))[0]
            require(promote_plain < TOL, f'packed {recipe} m={m}: promote {promote_plain} from '
                    f'plain')
            ms, plain_ms, library_ms = timed(kernel, plain, lambda: torch.matmul(a, b.t()))
            promote_ms = bench_kernel_ms(lambda: dense.dense_gemm(aq, bq, sfa, sfb, **kw))
            op_ms = bench_kernel_ms(call)
            bound, bound_fp8 = bf16_bound(arch, m, n, k, aq, bq, sfa_p, sfb_p)
            entries.append(dict(shape=[m, n, k], recipe=list(recipe), promote_ms=promote_ms,
                                op_ms=op_ms, vs_promote_calc_diff=vs_promote,
                                bound_fp8_ms=bound_fp8,
                                **numbers(ms, plain_ms, library_ms, err, bound)))
            log(f'phase 10 packed UE8M0 recipe={recipe} m={m} n={n} k={k}: dequant launches 1, '
                f'promote (pinned) launches 1; calc_diff dequant vs plain {diff:.3e}, vs promote '
                f'{vs_promote:.3e}, promote vs plain {promote_plain:.3e} (limit {TOL}) '
                f'max_abs_err={err:.4g}; dequant_ms={ms:.4f} promote_ms={promote_ms:.4f} '
                f'op_ms(dequant, with the unpack)={op_ms:.4f} plain_ms={plain_ms:.4f} '
                f'library_ms(torch.matmul bf16)={library_ms:.4f} bound_ms={bound[0]:.4f} '
                f'({bound[1]}, bf16 products; fp8 rate {bound_fp8:.4f}) '
                f'TFLOPS={2 * m * n * k / ms / 1e9:.1f}')
            del bq, sfb, d, d_promote
        del a, b, aq, sfa
        torch.cuda.empty_cache()
    return entries, launches


def phase_bf16_forms(gen, arch):
    """The dense forms on bf16 products that no other phase launches, at
    4096 x 4096 x 7168 through fp8_fp4_gemm_nt: an e4m3 A with packed UE8M0
    scales beside a packed FP4 B at gran 32 ('dequant' on the folded B, the
    mixed form), and two packed FP4 operands at gran 32 (both folded: bf16 x
    bf16). Each one launch of its form, bitwise the kernel on the folded
    operands, against its plain version, timed. Returns ({form: entry},
    {form: launches})."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.ops import sf_layout
    from deepgemm_tpu_torch.utils.math import decode_fp4_rows, per_token_cast_to_fp4
    m, n, k = FP4_SHAPE
    a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
    aq, sfa_p = dgt.per_token_cast_to_fp8(a, use_ue8m0=True, use_packed_ue8m0=True)
    sfa = sf_layout.transform_sfa(sfa_p, m, k, 128)
    a4 = per_token_cast_to_fp4(a, use_ue8m0=True, gran_k=32)
    b4 = per_token_cast_to_fp4(b, use_ue8m0=True, gran_k=32)
    fa, fb = decode_fp4_rows(a4[0], a4[1], 32), decode_fp4_rows(b4[0], b4[1], 32)
    cases = {
        'dequant_nt_mixed': (lambda: dgt.fp8_fp4_gemm_nt((aq, sfa_p), b4),
                             (aq, fb, sfa, None), dict(strategy='dequant'), (aq, sfa_p, *b4)),
        'bf16_nt': (lambda: dgt.fp8_fp4_gemm_nt(a4, b4), (fa, fb, None, None), {},
                    (*a4, *b4)),
    }
    entries, launches = {}, {}
    for form, (call, operands, kw, inputs) in cases.items():
        d = counted(call, form)
        launches[form] = 1
        kernel = lambda: dense.dense_gemm(*operands, **kw)
        plain = lambda: dense.dense_gemm_plain(*operands, **kw)
        require(torch.equal(d, kernel()), f'{form}: the op is not the kernel call')
        diff, err = compare(d, plain())
        require(diff < TOL, f'{form}: calc_diff {diff} against the plain version')
        ms, plain_ms, library_ms = timed(kernel, plain, lambda: torch.matmul(a, b.t()))
        op_ms = bench_kernel_ms(call)
        bound, bound_fp8 = bf16_bound(arch, m, n, k, *inputs)
        entries[form] = dict(shape=[m, n, k], op_ms=op_ms, bound_fp8_ms=bound_fp8,
                             **numbers(ms, plain_ms, library_ms, err, bound))
        log(f'phase 10 {form} (fp8_fp4_gemm_nt, FP4 at gran 32 folded) m={m} n={n} k={k}: '
            f'launches 1; bitwise the kernel on the folded operands; calc_diff={diff:.3e} '
            f'(limit {TOL}) max_abs_err={err:.4g}; kernel_ms={ms:.4f} op_ms(fold + kernel)='
            f'{op_ms:.4f} plain_ms={plain_ms:.4f} library_ms(torch.matmul bf16)={library_ms:.4f} '
            f'bound_ms={bound[0]:.4f} ({bound[1]}, bf16 products; fp8 rate {bound_fp8:.4f}) '
            f'TFLOPS={2 * m * n * k / ms / 1e9:.1f}')
        del d
    del a, b, aq, sfa, a4, b4, fa, fb
    torch.cuda.empty_cache()
    return entries, launches


def bench_kernel_ms(fn):
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    return bench_kernel(fn)


def phase_planar(gen, arch):
    """Planar FP4 B (n 7168, k 2048) decoded in the kernel at m 16, 128 and
    4096: one launch of its form, bitwise the fold route and the e4m3 kernel
    on the decoded codes, against the plain version; 'planar_in_kernel'
    and 'planar_fold' timed beside each other (the ops, decode included).
    Returns (entries, launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp4, repack_fp4_to_planar
    n, k = PLANAR_N, PLANAR_K
    b = randn_bf16((n, k), gen, 1.0)
    b4, sf4 = per_token_cast_to_fp4(b, use_ue8m0=True)
    planar = repack_fp4_to_planar(b4)
    codes = dense._decode_planar(planar)
    kw = dict(recipe_a=(1, 128), recipe_b=(1, 128))
    entries, launches = [], 0
    for m in PLANAR_MS:
        a = randn_bf16((m, k), gen, 1.0)
        aq, sfa = dgt.per_token_cast_to_fp8(a, use_ue8m0=False)
        in_kernel = lambda: dgt.fp8_fp4_gemm_nt((aq, sfa), (planar, sf4),
                                                fp4_layout='planar_in_kernel', **kw)
        fold = lambda: dgt.fp8_fp4_gemm_nt((aq, sfa), (planar, sf4), fp4_layout='planar_fold',
                                           **kw)
        d = counted(in_kernel, 'promote_nt_fp4')
        launches += 1
        require(torch.equal(d, fold()), f'planar m={m}: not bitwise the fold route')
        require(torch.equal(d, dense.dense_gemm(aq, codes, sfa, sf4, gran_n=1)),
                f'planar m={m}: not bitwise the e4m3 kernel on the decoded codes')
        kernel = lambda: dense.dense_gemm(aq, planar, sfa, sf4, gran_n=1, fp4_b=True)
        plain = lambda: dense.dense_gemm_plain(aq, planar, sfa, sf4, gran_n=1, fp4_b=True)
        diff, err = compare(d, plain())
        require(diff < TOL, f'planar m={m}: calc_diff {diff} against the plain version')
        ms, plain_ms, library_ms = timed(kernel, plain, lambda: torch.matmul(a, b.t()))
        op_ms, fold_ms = bench_kernel_ms(in_kernel), bench_kernel_ms(fold)
        e4m3_ms = bench_kernel_ms(lambda: dense.dense_gemm(aq, codes, sfa, sf4, gran_n=1))
        bound = dense_bound(arch, m, n, k, aq, sfa, planar, sf4)
        entries.append(dict(shape=[m, n, k], op_ms=op_ms, fold_op_ms=fold_ms,
                            e4m3_kernel_ms=e4m3_ms, **numbers(ms, plain_ms, library_ms, err,
                                                              bound)))
        log(f'phase 10 planar FP4 B in the kernel m={m} n={n} k={k}: launches 1 (fp4); bitwise '
            f'the fold route and the e4m3 kernel on the decoded codes; calc_diff={diff:.3e} '
            f'(limit {TOL}) max_abs_err={err:.4g}; kernel_ms={ms:.4f} (e4m3 kernel on the codes '
            f'{e4m3_ms:.4f}); op in_kernel_ms={op_ms:.4f} op fold_ms={fold_ms:.4f} '
            f'plain_ms={plain_ms:.4f} library_ms(torch.matmul bf16)={library_ms:.4f} '
            f'bound_ms={bound[0]:.4f} ({bound[1]})')
        del a, aq, sfa, d
    del b, b4, sf4, planar, codes
    torch.cuda.empty_cache()
    # where the two routes' op times, lines through the two largest m,
    # cross, and the fp4_decode_tflops that puts the crossover of
    # heuristics/arch.fp4_inkernel_profitable there
    (m0, t0, f0), (m1, t1, f1) = [(e['shape'][0], e['op_ms'], e['fold_op_ms'])
                                  for e in entries[-2:]]
    gain = (t1 - t0 - f1 + f0) / (m1 - m0)
    if gain > 0:
        cross = m0 + (f0 - t0) / gain
        fit = 1e-12 / (1 / (arch.hbm_bytes_per_s * cross) + 1 / (0.9 * arch.fp8_flops))
        log(f'phase 10 planar FP4 routes cross at m={cross:.0f} (lines through m {m0} and {m1}); '
            f'the fp4_decode_tflops that puts the model\'s crossover there: {fit:.1f} (the '
            f'H100 row holds {arch.fp4_decode_tflops})')
    else:
        log(f'phase 10 planar FP4 routes: the in-kernel route grows no faster than the fold '
            f'between m {m0} and {m1}; they do not cross')
    return entries, launches


def phase_fp4_gran32(gen, arch):
    """A packed FP4 B at scale granularity 32 (4096 x 4096 x 7168): JAX's
    bf16 fold, then one launch of the mixed e4m3 x bf16 form; against the
    op's plain route, timed. Returns (entry, launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.utils.math import decode_fp4_rows, per_token_cast_to_fp4
    m, n, k = FP4_SHAPE
    a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
    aq, sfa = dgt.per_token_cast_to_fp8(a, use_ue8m0=False)
    b4 = per_token_cast_to_fp4(b, use_ue8m0=True, gran_k=32)
    call = lambda: dgt.fp8_fp4_gemm_nt((aq, sfa), b4)
    d = counted(call, 'promote_nt_mixed')
    folded = decode_fp4_rows(b4[0], b4[1], 32)
    kernel = lambda: dense.dense_gemm(aq, folded, sfa, None)
    require(torch.equal(d, kernel()), 'FP4 gran 32: the op is not the mixed kernel call')
    plain = lambda: dense.dense_gemm_plain(aq, folded, sfa, None)
    diff, err = compare(d, plain_of(call)())
    require(diff < TOL, f'FP4 gran 32: calc_diff {diff} against the op\'s plain route')
    ms, plain_ms, library_ms = timed(kernel, plain, lambda: torch.matmul(a, b.t()))
    op_ms = bench_kernel_ms(call)
    bound, bound_fp8 = bf16_bound(arch, m, n, k, aq, sfa, *b4)
    entry = dict(shape=[m, n, k], op_ms=op_ms, bound_fp8_ms=bound_fp8,
                 **numbers(ms, plain_ms, library_ms, err, bound))
    log(f'phase 10 FP4 gran 32 m={m} n={n} k={k}: launches 1 (mixed e4m3 x bf16); calc_diff='
        f'{diff:.3e} against the op\'s plain route (limit {TOL}) max_abs_err={err:.4g}; '
        f'kernel_ms={ms:.4f} op_ms(fold + kernel)={op_ms:.4f} plain_ms={plain_ms:.4f} '
        f'library_ms(torch.matmul bf16)={library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}, '
        f'bf16 products; fp8 rate {bound_fp8:.4f}) TFLOPS={2 * m * n * k / ms / 1e9:.1f}')
    del a, b, aq, sfa, b4, d, folded
    torch.cuda.empty_cache()
    return entry, 1


def phase_contiguous_nn(seed, gen, arch):
    """The NN contiguous form at the training step's shapes on phase 9's
    seeded uneven layout, fp8 and bf16: one launch of the NN kernel through
    the op, bitwise the NT kernel on B transposed, against the plain
    version, timed beside the NT kernel on the same layout and the
    transposing copy of B that NT would need first (torch's, and the copy's
    bytes bound: B read and written once). Returns ({kind: entries}, {kind:
    launches})."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import grouped
    from deepgemm_tpu_torch.testing import count_bytes
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8, quantize_experts
    ids, counts, _ = dual_layout(seed)
    ends = counts.cumsum(0).to(torch.int32).cuda()
    m = ids.numel()
    live = int((counts > 0).sum())
    entries, launches = {'fp8': [], 'bf16': []}, {'fp8': 0, 'bf16': 0}
    for label, n, k in DUAL_SHAPES:
        for kind in ('fp8', 'bf16'):
            a = randn_bf16((m, k), gen, 1.0)
            b = randn_bf16((DUAL_EXPERTS, n, k), gen, k ** -0.5)
            if kind == 'fp8':
                aq, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
                b_nt, sfb = quantize_experts(b)
                del b
                b_nn = b_nt.view(torch.uint8).transpose(1, 2).contiguous().view(b_nt.dtype)
                sfb_mn = sfb.transpose(1, 2).contiguous()               # [G, ksf, nsf]
                ops, kw = (aq, b_nn), dict(sfa=sfa, sfb=sfb)
                op = lambda: dgt.m_grouped_fp8_gemm_nn_contiguous((aq, sfa), (b_nn, sfb_mn),
                                                                  grouped_layout=ids)
            else:
                b_nt, b_nn = b, b.transpose(1, 2).contiguous()
                del b
                ops, kw = (a, b_nn), {}
                op = lambda: dgt.m_grouped_bf16_gemm_nn_contiguous(a, b_nn, grouped_layout=ids)
            grouped.contiguous_nn_launches.update(bf16=0, fp8=0)
            grouped.contiguous_form_launches.clear()
            before = dict(grouped.contiguous_launches)
            d = op()
            torch.cuda.synchronize()
            seen = dict(grouped.contiguous_nn_launches)
            forms = dict(grouped.contiguous_form_launches)
            require(seen[kind] == 1 and sum(seen.values()) == 1
                    and grouped.contiguous_launches == before
                    and forms == {grouped.contiguous_form(kind, 'nn', 128): 1},
                    f'NN {kind} {label}: launches {seen} (by form {forms}), NT '
                    f'{grouped.contiguous_launches}')
            launches[kind] += 1
            require(torch.equal(d, grouped.contiguous_gemm(ops[0], b_nt, ids, **kw)),
                    f'NN {kind} {label}: not bitwise the NT kernel on B transposed')
            nt_ms = bench_kernel(lambda: grouped.contiguous_gemm(ops[0], b_nt, ids, **kw))
            copy_ms = bench_kernel(
                lambda: b_nn.view(torch.uint8 if kind == 'fp8' else b_nn.dtype).transpose(
                    1, 2).contiguous(), iters=3)
            copy_bound = arch.bound_ms(2 * count_bytes(b_nn), 0, kind)[0]
            library = None
            if kind == 'bf16':
                # one torch call of the same function, B in its own preferred layout
                library = lambda: torch._grouped_mm(a, b_nt.transpose(1, 2), offs=ends)
                lib_diff = calc_diff_of(library(), d)
                require(lib_diff < 1e-4, f'NN bf16 {label}: torch._grouped_mm is {lib_diff} '
                        f'from the kernel')
            else:
                del b_nt
            torch.cuda.empty_cache()
            kernel = lambda: grouped.contiguous_gemm(*ops, ids, b_mn=True, **kw)
            plain = lambda: grouped.contiguous_gemm_plain(*ops, ids, b_mn=True, **kw)
            diff, err = compare(d, plain())
            require(diff < TOL, f'NN {kind} {label}: calc_diff {diff} against the plain version')
            ms, plain_ms, library_ms = timed(kernel, plain, library)
            b_live = ops[1].numel() // DUAL_EXPERTS * live * ops[1].element_size()
            sfb_live = 0 if not kw else kw['sfb'].numel() // DUAL_EXPERTS * live * 4
            moved = count_bytes(ops[0], kw.get('sfa'), ids) + b_live + sfb_live + 2 * m * n
            bound = arch.bound_ms(moved, 2 * m * n * k, kind)
            entries[kind].append(dict(shape=[m, n, k, DUAL_EXPERTS], label=label, forms=forms,
                                      nt_ms=nt_ms, b_transpose_copy_ms=copy_ms,
                                      b_transpose_copy_bound_ms=copy_bound,
                                      **numbers(ms, plain_ms, library_ms, err, bound)))
            log(f'phase 10 contiguous NN {kind} {label} m={m} n={n} k={k} ({live} of '
                f'{DUAL_EXPERTS} experts with rows): NN launches 1 ({forms}), NT 0; bitwise the NT '
                f'kernel on B transposed; calc_diff={diff:.3e} (limit {TOL}) max_abs_err={err:.4g}; '
                f'kernel_ms={ms:.4f} (NT on the same layout {nt_ms:.4f}, B\'s transposing copy '
                f'{copy_ms:.4f}, its bound {copy_bound:.4f}) plain_ms={plain_ms:.4f} '
                + (f'library_ms(torch._grouped_mm bf16)={library_ms:.4f} ' if library else
                   'library_ms=null (torch._scaled_grouped_mm takes row-wise scales, not '
                   '1x128 / 128x128 block scales) ')
                + f'bound_ms={bound[0]:.4f} ({bound[1]})')
            del a, b_nn, ops, kw, d, library
            if kind == 'bf16':
                del b_nt
            torch.cuda.empty_cache()
    return entries, launches


def calc_diff_of(x, y):
    from deepgemm_tpu_torch.testing import calc_diff
    return calc_diff(x, y)


def phase_k_grouped_flat(gen, arch):
    """The flattened NT k-grouped form at the training step's L2 wgrad shape
    (256 groups of 128 rows: dw2 [256, 7168, 2048] f32, 15 GB): one launch,
    bitwise the TN kernel on the same data, 16 seeded groups against the
    plain version, timed. Returns (entry, launches)."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import k_grouped
    from deepgemm_tpu_torch.kernels.k_grouped import unflatten_k_major
    from deepgemm_tpu_torch.testing import count_bytes
    from deepgemm_tpu_torch.utils.math import per_channel_cast_to_fp8
    g, rows, m, n = KG_GROUPS, KG_ROWS, KG_M, KG_N
    ks = [rows] * g
    a_tn = randn_bf16((g * rows, m), gen, 1.0)
    b_tn = randn_bf16((g * rows, n), gen, 1.0)
    aq, sfa = per_channel_cast_to_fp8(a_tn, use_ue8m0=False)      # per group of 128 rows
    bq, sfb = per_channel_cast_to_fp8(b_tn, use_ue8m0=False)
    # each group's segment k-major, flattened: [g, m, rows]
    a_flat = aq.view(torch.uint8).view(g, rows, m).transpose(1, 2).contiguous().view(aq.dtype)
    b_flat = bq.view(torch.uint8).view(g, rows, n).transpose(1, 2).contiguous().view(bq.dtype)
    require(torch.equal(unflatten_k_major(a_flat, ks, m).view(torch.uint8), aq.view(torch.uint8)),
            'k-grouped flat: the flattening does not round-trip')
    sfa_mk, sfb_nk = sfa.t().contiguous(), sfb.t().contiguous()     # [m, nsf], the NT form's
    d_tmpl = torch.empty((g, m, n), device='meta')
    call = lambda: dgt.k_grouped_fp8_gemm_nt_contiguous((a_flat, sfa_mk), (b_flat, sfb_nk),
                                                        d=d_tmpl, ks=ks)
    k_grouped.flat_launches = 0
    k_grouped.launches.update(bf16=0, fp8=0)
    d = call()
    torch.cuda.synchronize()
    require(k_grouped.flat_launches == 1 and k_grouped.launches == {'bf16': 0, 'fp8': 0},
            f'k-grouped flat: launches {k_grouped.flat_launches}, TN {k_grouped.launches}')
    sizes = torch.full((g,), rows, dtype=torch.int32, device='cuda')
    d_tn = k_grouped.k_grouped_gemm(aq, bq, sizes, None, sfa, sfb)
    torch.cuda.synchronize()
    require(torch.equal(d, d_tn), 'k-grouped flat: not bitwise the TN kernel')
    del d_tn
    torch.cuda.empty_cache()
    pick = torch.randperm(g, generator=torch.Generator().manual_seed(1))[:16].sort().values
    sub = pick.cuda()
    take = lambda x: x.view(torch.uint8)[sub].view(x.dtype)
    ref = k_grouped.k_grouped_gemm_flat_plain(take(a_flat), take(b_flat), [rows] * 16, m, n,
                                              None, sfa[sub], sfb[sub])
    diff, err = compare(d[sub], ref)
    require(diff < TOL, f'k-grouped flat: calc_diff {diff} against the plain version (16 groups)')
    del d, ref
    torch.cuda.empty_cache()
    kernel = lambda: k_grouped.k_grouped_gemm_flat(a_flat, b_flat, ks, m, n, None, sfa, sfb)
    plain = lambda: k_grouped.k_grouped_gemm_flat_plain(a_flat, b_flat, ks, m, n, None, sfa, sfb)
    a3 = a_tn.view(g, rows, m).transpose(1, 2)
    b3 = b_tn.view(g, rows, n)
    ms, plain_ms, library_ms = timed(kernel, plain, lambda: torch.bmm(a3, b3))
    out_bytes = 4 * g * m * n
    moved = count_bytes(a_flat, b_flat, sfa, sfb) + out_bytes
    bound = arch.bound_ms(moved, 2 * m * n * g * rows, 'fp8')
    entry = dict(shape=[g, m, n, rows], out_bytes=out_bytes,
                 **numbers(ms, plain_ms, library_ms, err, bound))
    log(f'phase 10 k-grouped NT flat G={g} m={m} n={n} k_g={rows} ({out_bytes / 1e9:.2f} GB of f32 '
        f'out): flat launches 1, TN 0; bitwise the TN kernel; calc_diff={diff:.3e} on 16 groups '
        f'(limit {TOL}) max_abs_err={err:.4g}; kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} '
        f'library_ms(torch.bmm bf16)={library_ms:.4f} bound_ms={bound[0]:.4f} ({bound[1]}) '
        f'GB/s={moved / ms / 1e6:.1f}')
    del a_tn, b_tn, aq, bq, a_flat, b_flat, a3, b3
    torch.cuda.empty_cache()
    return entry, 1


def phase_surface(seed, gen, arch):
    """Phase 10: returns its kernels' JSON rows."""
    layouts, layout_launches = phase_layouts(gen, arch)
    c_entries, c_launches = phase_c(gen, arch)
    packed, packed_launches = phase_packed(gen, arch)
    planar, planar_launches = phase_planar(gen, arch)
    gran32, gran32_launches = phase_fp4_gran32(gen, arch)
    bf16_forms, bf16_launches = phase_bf16_forms(gen, arch)
    nn, nn_launches = phase_contiguous_nn(seed, gen, arch)
    flat, flat_launches = phase_k_grouped_flat(gen, arch)

    def row(name, source, replaces, launches, entries, design=WIDEN_DESIGN):
        return dict(name=name, route='cuda', source=f'deepgemm_tpu_torch/csrc/{source}',
                    replaces=replaces, launches=launches, design=design, **summed(entries),
                    shapes=entries)

    dense_at = 'deepgemm_tpu/kernels/dense.py:291'
    return [
        *(row(f'dense_fp8_gemm_{layout}', 'dense.cu', dense_at, layout_launches[layout],
              layouts[layout], design=f'k-major copy of the MN-major operand, then {HOPPER_DESIGN}')
          for layout in LAYOUTS),
        row('dense_fp8_gemm_nt_c', 'dense.cu', dense_at, c_launches, c_entries, HOPPER_DESIGN),
        row('dense_fp8_gemm_dequant', 'dense_dequant.cu', dense_at, packed_launches, packed),
        row('dense_fp8_gemm_nt_planar_fp4', 'dense.cu', dense_at, planar_launches, planar,
            f'{HOPPER_DESIGN}; planar FP4 B decoded in shared memory'),
        row('dense_fp8_gemm_nt_fp4_gran32', 'dense_dequant.cu', dense_at, gran32_launches,
            [gran32]),
        row('dense_fp8_gemm_nt_mixed_dequant', 'dense_dequant.cu', dense_at,
            bf16_launches['dequant_nt_mixed'], [bf16_forms['dequant_nt_mixed']]),
        row('dense_gemm_nt_bf16_folded', 'dense_dequant.cu', dense_at, bf16_launches['bf16_nt'],
            [bf16_forms['bf16_nt']],
            'wgmma bf16 m64n128k16 from TMA-fed 128-byte-swizzled stages, warp-specialised '
            'persistent grid, TMA-store epilogue (csrc/gemm_sm90.cuh gemm_kernel, unscaled)'),
        *(row(f'contiguous_grouped_gemm_nn_{kind}', 'contiguous.cu',
              'deepgemm_tpu/kernels/grouped.py:240', nn_launches[kind], nn[kind],
              f'{CONTIGUOUS_DESIGN}; B MN-major: ' + (
                  'each stage transposed in shared memory' if kind == 'fp8' else
                  "wgmma's transposed B"))
          for kind in ('fp8', 'bf16')),
        row('k_grouped_gemm_nt_flat_fp8', 'k_grouped.cu', 'deepgemm_tpu/kernels/k_grouped.py:237',
            flat_launches, [flat], f'{HOPPER_DESIGN}; a tensor map per group'),
    ]


# Phase 11: the expert-parallel mega MoE serving forward over a mesh of 8
# ranks on this one card (devices [cuda:0] * 8: one thread and one CUDA
# stream a rank; the kernels take the ranks' buffer addresses, local here,
# NVLink addresses across cards), DeepSeek-V3 widths (the phase 5 config),
# EP 8 (32 experts a rank: one 8-GPU NVLink node, the reference's mega MoE
# test mesh), [8, 128] tokens (128 a rank: a (rank, expert) slot of
# align(ceil(128 * 8 / 256) * 8 + 1, 8) = 40 rows, so every rank's kernel
# runs 8 x 40 = 320 rows a local expert).
EP = 8
EP_BATCH_SHAPE = (8, 128)
EP_EXPERTS = V3['num_experts'] // EP
EP_CAP = 40
EP_UNFUSED_LIMIT = MEGA_UNFUSED_LIMIT['0']     # bf16 act, tests/test_mega_moe.py:254
NVLINK_BYTES_PER_S = 450e9                     # each way (hopper-kernels guide)


@contextlib.contextmanager
def plain_chunks(nbytes):
    """The plain versions upcast weights in chunks of ``nbytes`` (whole
    experts or groups, so no bit changes): eight ranks run them at once on
    one card beside the model's weights."""
    from deepgemm_tpu_torch.kernels import fused_moe, grouped
    before = fused_moe._PLAIN_CHUNK_BYTES, grouped._PLAIN_CHUNK_BYTES
    fused_moe._PLAIN_CHUNK_BYTES = grouped._PLAIN_CHUNK_BYTES = nbytes
    try:
        yield
    finally:
        fused_moe._PLAIN_CHUNK_BYTES, grouped._PLAIN_CHUNK_BYTES = before


def mesh_bench(mesh, fn, args, iters=5, warmup=1):
    """Milliseconds of one call of ``fn`` on every rank of ``mesh``: after an
    L2 flush, each rank's call is bracketed by CUDA events on its own
    stream. A rank's time includes its wait for the last peer to start, so
    the call's time is the least over the ranks (the last rank to start
    waits for no one, and ends when its peers' stores have landed). Mean
    over ``iters``."""
    for _ in range(warmup):
        mesh.map(lambda *a: fn(*a) is None, *args)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device='cuda')

    def timed(*a):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a)
        end.record()
        return start, end

    total = 0.0
    for _ in range(iters):
        flush.zero_()
        events = mesh.map(timed, *args)
        torch.cuda.synchronize()
        total += min(s.elapsed_time(e) for s, e in events)
    return total / iters


def kernel_device_ms(mesh, fn, args, name):
    """One call of ``fn`` on every rank under torch.profiler: the device
    time of each rank's kernel whose name holds ``name`` (a rank's includes
    its wait for its peers, so the least is the call's), and the device time
    of everything else the call ran, summed over the ranks. Returns (least,
    most, other) in ms, or None without device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    mesh.map(lambda *a: fn(*a) is None, *args)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        mesh.map(lambda *a: fn(*a) is None, *args)
        torch.cuda.synchronize()
    mine, other = [], 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if name in e.name:
                mine.append(e.time_range.elapsed_us() / 1e3)
            else:
                other += e.time_range.elapsed_us() / 1e3
    return (min(mine), max(mine), other) if mine else None


def profile_mesh(fn, label, what):
    """One call of ``fn`` under torch.profiler, the ranks' streams running at
    once: wall time, the union of the device's busy intervals (kernels,
    copies, sets on any stream), the idle share of the wall time, and the
    device time by name. Returns (wall_ms, busy_ms) or None without device
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            us, calls = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), calls + 1)
    if not spans:
        log(f'profile {label}: wall_ms={wall_ms:.3f}; the profiler saw no device events, '
            f'device time not measured')
        return None
    busy, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    busy_ms = busy / 1e3
    log(f'profile {label}: wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} (union over '
        f'streams) device_idle_share={1 - busy_ms / wall_ms:.4f} device_ms_summed='
        f'{sum(us for us, _ in by_name.values()) / 1e3:.3f} ({what}, under the profiler)')
    for name, (us, calls) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f'  {us / 1e3:10.3f} ms device, {calls:6d} calls: {name[:130]}')
    return wall_ms, busy_ms


def ep_a2a(gen, arch):
    """#15 at the pipeline's dispatch shape (per rank [8, 32, 40, 7168] bf16)
    and its weight sideband ([8, 32, 40] f32): bitwise the host all-to-all
    on every rank, three back-to-back calls with other inputs, at 8, 2 and
    4 ranks; then timed at 8 ranks."""
    from deepgemm_tpu_torch.parallel import collectives, dist
    slab = (EP_EXPERTS, EP_CAP, V3['hidden'])
    for d in (EP, 2, 4):
        mesh = dist.make_mesh([('ep', d)], ['cuda:0'] * d)
        before = collectives.launches
        for call in range(3):
            x = randn_bf16((d, d, *slab), gen, 1.0)
            w = torch.rand((d, d, *slab[:2]), generator=gen, device='cuda')
            outs = mesh.map(lambda a, b: (collectives.pallas_all_to_all(a, 'ep'),
                                          collectives.pallas_all_to_all(b, 'ep'),
                                          dist.all_to_all(a, 'ep'), dist.all_to_all(b, 'ep')),
                            list(x), list(w))
            torch.cuda.synchronize()
            for r, (ka, kb, ha, hb) in enumerate(outs):
                require(torch.equal(ka, ha) and torch.equal(kb, hb),
                        f'#15 at {d} ranks, call {call}: rank {r} differs from the all-to-all')
            del outs
        launches = collectives.launches - before
        require(launches == 3 * 2 * d, f'#15 at {d} ranks: {launches} launches, expected {6 * d}')
        log(f'phase 11 a2a at {d} ranks [{d}, {", ".join(map(str, slab))}] bf16 and its '
            f'[{d}, {slab[0]}, {slab[1]}] f32 sideband: 3 back-to-back calls with other inputs, '
            f'every rank bitwise the host all-to-all ({launches} launches)')
        if d == EP:
            args = [list(x)]
            ms = mesh_bench(mesh, lambda a: collectives.pallas_all_to_all(a, 'ep'), args)
            ms_w = mesh_bench(mesh, lambda b: collectives.pallas_all_to_all(b, 'ep'), [list(w)])
            from deepgemm_tpu_torch.kernels.common import plain_versions
            with plain_versions():
                plain_ms = mesh_bench(mesh, lambda a: collectives.pallas_all_to_all(a, 'ep'),
                                      args)
            library_ms = mesh_bench(mesh, lambda a: dist.all_to_all(a, 'ep'), args)
            payload = x.numel() * x.element_size()              # every rank's input
            bound = arch.bound_ms(2 * payload, 0, 'bf16')
            nvlink_ms = (d - 1) / d * payload / d / NVLINK_BYTES_PER_S * 1e3
            log(f'phase 11 time a2a [8 ranks on one card, {payload / d / 1e6:.1f} MB a rank]: '
                f'kernel_ms={ms:.4f} (sideband {ms_w:.4f}) plain_ms={plain_ms:.4f} '
                f'library_ms(one copy_ a slab a rank, the host all-to-all)={library_ms:.4f} '
                f'bound_ms={bound[0]:.4f} ({bound[1]}: every rank\'s input read and output '
                f'written once at 3.35 TB/s) nvlink_bound_ms(8 cards: each rank\'s off-rank '
                f'bytes at 450 GB/s)={nvlink_ms:.4f} GB/s={2 * payload / ms / 1e6:.1f}; NCCL '
                f'cannot run 8 ranks on one device')
            result = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, max_abs_err=0.0,
                          bound_ms=bound[0], bound_by=bound[1], nvlink_bound_ms=nvlink_ms,
                          sideband_ms=ms_w, shape=[d, *slab])
        del mesh, x, w
        torch.cuda.empty_cache()
    return result


def dispatch_operands(w, gen):
    """#12's operands at V3's L1 on the EP ranks (phase 11's shapes) for the
    weights ``w`` [EP E_local, N, H]: (the call, a rank's send tokens,
    ((kind, per-rank arguments), ...) for fp8 (e4m3 with per-token scales)
    and bf16)."""
    from deepgemm_tpu_torch.kernels import fused_moe
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8, quantize_experts
    e_local, cap, hidden = EP_EXPERTS, EP_CAP, V3['hidden']
    send = randn_bf16((EP, EP, e_local, cap, hidden), gen, 1.0)
    sq, ssf = per_token_cast_to_fp8(send.view(-1, hidden), use_ue8m0=False)
    sq, ssf = sq.view(send.shape), ssf.view(*send.shape[:-1], -1)
    wq, wsf = quantize_experts(w)
    cut = lambda t: [t[r * e_local:(r + 1) * e_local] for r in range(EP)]
    call = lambda s, ssf_, ww, wwsf: fused_moe.fused_dispatch_gemm(s, ww, send_sf=ssf_, w_sf=wwsf)
    return call, send[0], (('fp8', (list(sq), list(ssf), cut(wq), cut(wsf))),
                           ('bf16', (list(send), [None] * EP, cut(w), [None] * EP)))


def masked_operands(gen):
    """The masked kernel's decode calls (phase 4's shapes, every row live):
    for each of MASKED_SHAPES (label, [G, max_m, n, k], a, b, masked_m,
    ((kind, operands, keywords), ...) for fp8 and bf16), made as it is
    taken."""
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8, quantize_experts
    for label, g, max_m, n, k in MASKED_SHAPES:
        a = randn_bf16((g, max_m, k), gen, 1.0)
        b = randn_bf16((g, n, k), gen, k ** -0.5)
        full = torch.full((g,), max_m, dtype=torch.int32, device='cuda')
        aq, asf = per_token_cast_to_fp8(a.view(-1, k), use_ue8m0=False)
        aq, asf = aq.view(g, max_m, k), asf.view(g, max_m, -1)
        bq, bsf = quantize_experts(b)
        yield label, [g, max_m, n, k], a, b, full, (('fp8', (aq, bq), dict(sfa=asf, sfb=bsf)),
                                                   ('bf16', (a, b), {}))
        del a, b, aq, asf, bq, bsf
        torch.cuda.empty_cache()


def einsum_operands(gen):
    """fp8_einsum bhr,hdr->bhd's call (phase 9's shapes): (x, w, the masked
    kernel's a, b, masked_m and keywords)."""
    from deepgemm_tpu_torch.utils.math import per_block_cast_to_fp8
    tokens, h, r, dv = MLA_TOKENS, MLA_HEADS, MLA_RANK, MLA_DIM
    x = randn_bf16((tokens, h, r), gen, 1.0)
    w = randn_bf16((h, dv, r), gen, r ** -0.5)
    x_q, w_q = cast_heads(x), per_block_cast_to_fp8(w, use_ue8m0=False)
    a_t, sfa_t = (t.transpose(0, 1).contiguous() for t in x_q)
    full = torch.full((h,), tokens, dtype=torch.int32, device='cuda')
    return x, w, (a_t, w_q[0], full), dict(sfa=sfa_t, sfb=w_q[1])


def ep_dispatch(mesh, w, gen, arch):
    """#12 at V3's L1 (N 4096, H 7168; 8 ranks of 32 experts, cap 40), e4m3
    with per-token scales and bf16: recv bitwise the all-to-all, out bitwise
    the masked kernel (#2) on recv and within TOL of the plain version;
    each timed. Returns ({kind: numbers}, launches of the own-path call)."""
    from deepgemm_tpu_torch.kernels import fused_moe, grouped
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.parallel import dist
    from deepgemm_tpu_torch.testing import count_bytes
    e_local, cap, hidden = EP_EXPERTS, EP_CAP, V3['hidden']
    n = w.shape[1]
    call, send, cases = dispatch_operands(w, gen)
    out, launches = {}, {}
    for kind, args in cases:
        def checked(s, ssf_, ww, wwsf):
            got, recv = call(s, ssf_, ww, wwsf)
            want = dist.all_to_all(s, 'ep')
            a = want.transpose(0, 1).reshape(e_local, EP * cap, hidden)
            sfa = None
            if ssf_ is not None:
                sfa = dist.all_to_all(ssf_, 'ep').transpose(0, 1).reshape(e_local, EP * cap, -1)
            full = torch.full((e_local,), EP * cap, dtype=torch.int32, device='cuda')
            masked = grouped.masked_gemm(a, ww, full, sfa=sfa, sfb=wwsf)
            return got, recv, want, masked.view(e_local, EP, cap, n)

        fused_moe.dispatch_launches[kind] = 0
        outs = mesh.map(checked, *args)
        torch.cuda.synchronize()
        launches[kind] = fused_moe.dispatch_launches[kind]
        with plain_versions(), plain_chunks(1 << 29):
            plain = mesh.map(call, *args)
        torch.cuda.synchronize()
        diffs, errs = [], []
        for r, ((got, recv, want, masked), (p_out, _)) in enumerate(zip(outs, plain)):
            require(torch.equal(recv.view(torch.uint8), want.view(torch.uint8)),
                    f'#12 {kind}: rank {r} recv differs from the all-to-all')
            require(torch.equal(got, masked), f'#12 {kind}: rank {r} out differs from #2 on recv')
            diff, err = compare(got, p_out)
            diffs.append(diff)
            errs.append(err)
        require(max(diffs) < TOL, f'#12 {kind}: calc_diff {max(diffs)} against the plain version')
        del outs, plain
        ms = mesh_bench(mesh, call, args, iters=3)
        device = kernel_device_ms(mesh, call, args, 'dispatch_gemm_kernel')
        with plain_versions(), plain_chunks(1 << 29):
            plain_ms = mesh_bench(mesh, call, args, iters=1, warmup=0)
        rows = EP * EP * e_local * cap
        # inputs read once; out [E, D, cap, N] bf16 and recv written once, a rank
        num_bytes = (count_bytes(*[t for a in args for t in a if t is not None])
                     + EP * (e_local * EP * cap * n * 2
                             + send.numel() * args[0][0].element_size()))
        bound = arch.bound_ms(num_bytes, 2 * rows * n * hidden, kind)
        out[kind] = dict(ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=max(errs),
                         bound_ms=bound[0], bound_by=bound[1], check_calc_diff=max(diffs),
                         shape=[EP, e_local, cap, n, hidden], device_ms=device)
        log(f'phase 11 dispatch_gemm {kind} [8 ranks, E_local {e_local}, cap {cap}, N {n}, H '
            f'{hidden}]: recv bitwise the all-to-all, out bitwise the masked kernel on recv on '
            f'every rank, calc_diff={max(diffs):.3e} (limit {TOL}) max_abs_err={max(errs):.4g} '
            f'against the plain version; launches {launches[kind]} (one a rank); '
            f'kernel_ms={ms:.4f} (device ms under the profiler, least / most rank / other ops '
            f'summed: {device}) plain_ms={plain_ms:.4f} library_ms=None (no one PyTorch call '
            f'moves and multiplies) '
            f'bound_ms={bound[0]:.4f} ({bound[1]}) TFLOPS={2 * rows * n * hidden / ms / 1e9:.1f}')
    del send, cases
    torch.cuda.empty_cache()
    return out, launches


def ep_mega(mesh, layer, gen, arch):
    """#14 on one layer's weights (fp8; planar FP4 at 2 ranks), 8 ranks of
    32 experts, cap 40: pools 1, 2, 4, 8 bitwise each other; every rank's
    combine slab from rank s bitwise the one-rank kernel (#13) on the rows
    s received from it, with bf16 and with fp8 act; within TOL of the plain
    version; force_general at one rank bitwise #13; FP4 at 2 ranks bitwise
    the decoded fp8; timed. Returns numbers."""
    from deepgemm_tpu_torch.kernels import fused_moe
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.parallel import dist
    from deepgemm_tpu_torch.testing import count_bytes
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8, quantize_experts
    e_local, cap, hidden, inter = EP_EXPERTS, EP_CAP, V3['hidden'], V3['moe_intermediate']
    send = randn_bf16((EP, EP, e_local, cap, hidden), gen, 1.0)
    send[..., cap - 4:, :] = 0                             # empty slots
    sq, ssf = per_token_cast_to_fp8(send.view(-1, hidden), use_ue8m0=False)
    sq, ssf = sq.view(send.shape), ssf.view(*send.shape[:-1], -1)
    del send
    rw = torch.rand((EP, EP, e_local, cap), generator=gen, device='cuda')
    (q1, s1), (q2, s2) = quantize_experts(layer['w1']), quantize_experts(layer['w2'])
    cut = lambda t, ranks=EP: [t[r * e_local:(r + 1) * e_local] for r in range(ranks)]
    weights = (cut(q1), cut(s1), cut(q2), cut(s2))

    def call(pool, act_fp8, w_fp4=False):
        return lambda s, sf, r, a1, b1, a2, b2: fused_moe.mega_ep(
            s, sf, r, a1, b1, a2, b2, pool=pool, w_fp4=w_fp4, act_fp8=act_fp8,
            silu_tanh=not act_fp8)

    args = (list(sq), list(ssf), list(rw), *weights)
    default_pool = fused_moe.pick_wave_pool(EP, cap, hidden, inter, xb=1, wb=1, scaled=True,
                                            act_fp8=False)
    checks = []
    pools = {}
    for pool in (1, 2, 4, 8):
        pools[pool] = mesh.map(call(pool, False), *args)
        torch.cuda.synchronize()
        if pool > 1:
            for r in range(EP):
                require(torch.equal(pools[pool][r], pools[1][r]),
                        f'#14: pool {pool} differs from pool 1 at rank {r}')
    checks.append('pools 1, 2, 4, 8 bitwise equal')
    act8 = mesh.map(call(default_pool, True), *args)
    torch.cuda.synchronize()
    for act_fp8, got in ((False, pools[1]), (True, act8)):
        for r in range(EP):
            for s in range(EP):
                step = (s - r) % EP
                block = fused_moe.mega_local(sq[r, s], ssf[r, s], rw[s, step], weights[0][s],
                                             weights[1][s], weights[2][s], weights[3][s],
                                             act_fp8=act_fp8, silu_tanh=not act_fp8)
                require(torch.equal(got[r][s], block),
                        f'#14 act {"fp8" if act_fp8 else "bf16"}: rank {r} slab from {s} differs '
                        f'from #13 on the rows it received')
    checks.append('every combine slab bitwise #13 on the rows received (bf16 and fp8 act)')
    del pools, act8
    with plain_versions(), plain_chunks(1 << 29):
        plain = mesh.map(call(default_pool, False), *args)
    got = mesh.map(call(default_pool, False), *args)
    torch.cuda.synchronize()
    diffs, errs = zip(*(compare(g, p) for g, p in zip(got, plain)))
    require(max(diffs) < TOL, f'#14: calc_diff {max(diffs)} against the plain version')
    del plain, got
    # force_general at one rank: the general kernel bitwise the one-rank kernel
    one = dist.make_mesh([('ep', 1)], ['cuda:0'])
    general = one.map(lambda s, sf, r: fused_moe.fused_mega_moe(
        s, r, q1[:e_local], q2[:e_local], send_sf=sf, w1_sf=s1[:e_local], w2_sf=s2[:e_local],
        force_general=True, act_fp8=False), [sq[0, :1]], [ssf[0, :1]], [rw[0, :1]])[0]
    local = fused_moe.fused_mega_moe(sq[0, :1], rw[0, :1], q1[:e_local], q2[:e_local],
                                     send_sf=ssf[0, :1], w1_sf=s1[:e_local], w2_sf=s2[:e_local],
                                     act_fp8=False)
    torch.cuda.synchronize()
    require(torch.equal(general, local), '#14 force_general at one rank differs from #13')
    checks.append('force_general at one rank bitwise #13')
    del one, general, local
    # planar FP4 weights at 2 ranks (JAX's test_mega_fused_fp4_weights_bitwise)
    two = dist.make_mesh([('ep', 2)], ['cuda:0'] * 2)
    f1, g1 = fp4_blocks(layer['w1'][:2 * e_local])
    f2, g2 = fp4_blocks(layer['w2'][:2 * e_local])
    a2 = (list(sq[:2, :2]), list(ssf[:2, :2]), list(rw[:2, :2]))
    y4 = two.map(call(1, False, w_fp4=True), *a2, cut(f1, 2), cut(g1, 2), cut(f2, 2),
                 cut(g2, 2))
    y8 = two.map(call(1, False), *a2, cut(decode_fp4(f1), 2), cut(g1, 2),
                 cut(decode_fp4(f2), 2), cut(g2, 2))
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(y4, y8)),
            '#14 FP4 weights differ from the decoded fp8 at 2 ranks')
    checks.append('planar FP4 at 2 ranks bitwise the decoded fp8')
    del two, y4, y8, f1, f2
    ms = mesh_bench(mesh, call(default_pool, False), args, iters=3)
    with plain_versions(), plain_chunks(1 << 29):
        plain_ms = mesh_bench(mesh, call(default_pool, False), args, iters=1, warmup=0)
    rows = EP * EP * e_local * cap
    flops = 2 * rows * (2 * inter * hidden + hidden * inter)
    num_bytes = count_bytes(sq, ssf, rw, q1, s1, q2, s2) + 2 * sq.numel()
    bound = arch.bound_ms(num_bytes, flops, 'fp8')
    log(f'phase 11 mega_ep [8 ranks, E_local {e_local}, cap {cap}, H {hidden}, I {inter}; fp8 '
        f'weights, bf16 act, pool {default_pool}]: {", ".join(checks)}; calc_diff='
        f'{max(diffs):.3e} (limit {TOL}) max_abs_err={max(errs):.4g} against the plain version; '
        f'kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms=None (no one PyTorch call '
        f'dispatches, runs the block and combines) bound_ms={bound[0]:.4f} ({bound[1]}) '
        f'TFLOPS={flops / ms / 1e9:.1f}')
    del q1, s1, q2, s2, sq, ssf, rw, weights, args
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=max(errs),
                bound_ms=bound[0], bound_by=bound[1], check_calc_diff=max(diffs),
                pool=default_pool, shape=[EP, e_local, cap, hidden, inter])


def ep_walk(mesh, params, tokens, cfg_fused, cfg_xla):
    """Layer by layer on the fused path's own states, over the mesh: each
    layer's fused MoE output against its plain version and against 'xla'
    on the same input, and the (token, expert) pairs its routing drops at
    the mesh's capacity (a slot a rank) and at one rank's (a slot for the
    whole batch). Returns [(plain diff, xla diff)], [(mesh drops, one-rank
    drops)] and the logits."""
    from deepgemm_tpu_torch.kernels.common import plain_versions
    from deepgemm_tpu_torch.models.transformer import attention, moe_block, rms_norm
    from deepgemm_tpu_torch.parallel.moe import dispatch_indices, moe_capacity
    from deepgemm_tpu_torch.utils.math import topk_stable
    from deepgemm_tpu_torch.testing import calc_diff
    x = params['embed'][tokens]
    diffs, dropped = [], []
    experts, topk = cfg_fused.num_experts, cfg_fused.topk
    for layer in params['layers']:
        h = x + attention(rms_norm(x, layer['ln1']), layer['wqkv'], layer['wo'], cfg_fused)
        moe_in = rms_norm(h, layer['ln2'])
        flat = moe_in.reshape(-1, moe_in.shape[-1])
        idx = topk_stable(flat.float() @ layer['router'].t(), topk)[1]
        per_rank = idx.shape[0] // mesh.size
        cap_mesh = moe_capacity(per_rank, topk, experts, cfg_fused.capacity_factor)
        cap_one = moe_capacity(idx.shape[0], topk, experts, cfg_fused.capacity_factor)
        dropped.append((sum(int(dispatch_indices(part, experts, cap_mesh)[3])
                            for part in idx.chunk(mesh.size)),
                        int(dispatch_indices(idx, experts, cap_one)[3])))
        y = moe_block(moe_in, layer, cfg_fused, mesh)
        with plain_versions(), plain_chunks(1 << 29):
            y_plain = moe_block(moe_in, layer, cfg_fused, mesh)
        y_xla = moe_block(moe_in, layer, cfg_xla, mesh)
        require(torch.isfinite(y.float()).all().item(), 'mesh MoE output not finite')
        diffs.append((calc_diff(y, y_plain), calc_diff(y, y_xla)))
        x = h + y
    embed = params['embed'].float()
    return diffs, dropped, torch.matmul(rms_norm(x, params['final_norm']).float(), embed.t())


def ep_zero():
    """Sets the counts that the 8-rank forward reads to 0."""
    from deepgemm_tpu_torch.kernels import dense, fused_moe, grouped
    from deepgemm_tpu_torch.parallel import collectives
    for counts in (fused_moe.launches, fused_moe.ep_launches, fused_moe.dispatch_launches):
        for key in counts:
            counts[key] = 0
    grouped.launches.update(bf16=0, fp8=0, fp8_f32=0)
    dense.launches = 0
    collectives.launches = 0


def ep_seen():
    """The kernel launches of the 8-rank forward since :func:`ep_zero`."""
    from deepgemm_tpu_torch.kernels import dense, fused_moe, grouped
    from deepgemm_tpu_torch.parallel import collectives
    return dict(mega_ep=sum(fused_moe.ep_launches.values()),
                mega_local=sum(fused_moe.launches.values()),
                masked=sum(grouped.launches.values()), a2a=collectives.launches,
                dispatch=sum(fused_moe.dispatch_launches.values()), dense=dense.launches)


def ep_main_path(mesh, params, seed):
    """Phase 11's main path: the model forward over the 8-rank mesh through
    its entry point, mega_comm='fused', on three [8, 128] batches: launches
    (the general kernel 1 a layer a rank, nothing else), finite logits of
    the right shape, tokens/s after the first batch and peak memory.
    Returns (the sharded parameters, the batches, the fused config, the
    logits, the numbers)."""
    from deepgemm_tpu_torch.kernels import fused_moe
    from deepgemm_tpu_torch.models.convert import shard_experts
    from deepgemm_tpu_torch.models.transformer import ModelConfig, forward
    gen = torch.Generator(device='cuda').manual_seed(seed + 13)
    batches = [torch.randint(0, V3['vocab'], EP_BATCH_SHAPE, generator=gen, device='cuda')
               for _ in range(BATCHES)]
    cfg_fused = ModelConfig(**V3, use_fp8=True, use_kernels=True, use_mega=True,
                            mega_comm='fused')
    sharded = shard_experts(params, mesh)                  # views: one card
    layers = V3['num_layers']
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    # the main path: counts at 0 just before, read just after
    ep_zero()
    logits, seconds = [], []
    for tokens in batches:
        t0 = time.perf_counter()
        logits.append(forward(sharded, tokens, cfg_fused, mesh))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    got = ep_seen()
    want = dict(mega_ep=layers * EP * BATCHES, mega_local=0, masked=0, a2a=0, dispatch=0, dense=0)
    require(got == want and fused_moe.ep_launches['fp8'] == want['mega_ep'],
            f'mesh forward fused: launches {got}, expected {want} (fp8 instance)')
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_tok = EP_BATCH_SHAPE[0] * EP_BATCH_SHAPE[1]
    tokens_per_s = (BATCHES - 1) * n_tok / sum(seconds[1:])
    for lk in logits:
        require(tuple(lk.shape) == (*EP_BATCH_SHAPE, V3['vocab']), f'logits {tuple(lk.shape)}')
        require(torch.isfinite(lk).all().item(), 'mesh forward: logits not finite')
    log(f'phase 11 forward over 8 ranks, mega fused: launches {got} (per forward: the general '
        f'kernel {layers} a rank, nothing else) tokens/s={tokens_per_s:.1f} (batches 2-{BATCHES} '
        f'of {EP_BATCH_SHAPE}; seconds per batch {[round(v, 4) for v in seconds]}, the first '
        f'with warm-up, fp8 weight quantization in every call) peak_mem={peak_gb:.2f} GB')
    return sharded, batches, cfg_fused, logits, dict(
        launches=dict(mega_ep=got['mega_ep']), tokens_per_s=tokens_per_s, peak_gb=peak_gb,
        seconds=seconds)


def ep_forward(mesh, params, seed):
    """The model forward over the 8-rank mesh through its entry point:
    'fused' (the main path, :func:`ep_main_path`); 'xla' and 'pallas' (one
    chunk) on the first batch, 'pallas' bitwise 'xla'; the per-layer walk;
    the logits beside the one-rank forward's; a profile. Returns the
    numbers of the main path and the profile."""
    from deepgemm_tpu_torch.models.transformer import ModelConfig, forward
    from deepgemm_tpu_torch.testing import calc_diff
    sharded, batches, cfg_fused, logits, numbers = ep_main_path(mesh, params, seed)
    base = dict(V3, use_fp8=True, use_kernels=True, use_mega=True)
    cfg_xla = ModelConfig(**base, mega_comm='xla', mega_chunks=1)
    cfg_pallas = ModelConfig(**base, mega_comm='pallas', mega_chunks=1)
    layers = V3['num_layers']
    launches = numbers['launches']
    # 'xla' and 'pallas', one chunk each: bitwise equal
    ep_zero()
    l_xla = forward(sharded, batches[0], cfg_xla, mesh)
    torch.cuda.synchronize()
    got_xla = ep_seen()
    ep_zero()
    l_pallas = forward(sharded, batches[0], cfg_pallas, mesh)
    torch.cuda.synchronize()
    got_pallas = ep_seen()
    want_xla = dict(mega_ep=0, mega_local=0, masked=2 * layers * EP, a2a=0, dispatch=0, dense=0)
    want_pallas = dict(want_xla, a2a=3 * layers * EP)
    require(got_xla == want_xla and got_pallas == want_pallas,
            f"mesh forward: 'xla' launches {got_xla} (expected {want_xla}), 'pallas' "
            f"{got_pallas} (expected {want_pallas})")
    require(torch.equal(l_xla, l_pallas), "mesh forward: 'pallas' differs from 'xla'")
    launches['a2a'] = got_pallas['a2a']
    log(f"phase 11 forward over 8 ranks, 'xla' and 'pallas' (1 chunk): logits bitwise equal; "
        f"launches 'xla' {got_xla}, 'pallas' {got_pallas} (a layer a rank: masked 2, and under "
        f"'pallas' the all-to-all 3: tokens, row weights, combine); fused against 'xla' "
        f"logits calc_diff {calc_diff(logits[0], l_xla):.3e} (printed, not held: routing flips)")
    diffs, dropped, walked = ep_walk(mesh, sharded, batches[0], cfg_fused, cfg_xla)
    require(torch.equal(walked, logits[0]), 'mesh forward: the walk differs from forward')
    plain_d, xla_d = [d for d, _ in diffs], [d for _, d in diffs]
    require(max(plain_d) < TOL and max(xla_d) < EP_UNFUSED_LIMIT,
            f'mesh fused per layer: against plain {plain_d} (limit {TOL}), against xla {xla_d} '
            f'(limit {EP_UNFUSED_LIMIT})')
    log(f"  per layer fused MoE vs plain {[f'{d:.3e}' for d in plain_d]} (limit {TOL}), vs "
        f"'xla' (masked kernels) {[f'{d:.3e}' for d in xla_d]} (limit {EP_UNFUSED_LIMIT}); the "
        f"walk equals forward bitwise")
    # beside the one-rank forward (phase 8's code) on the same tokens
    one_fused = forward(params, batches[0], cfg_fused)
    one_unfused = forward(params, batches[0], ModelConfig(**dict(V3, use_fp8=True,
                                                                 use_kernels=True)))
    torch.cuda.synchronize()
    log(f"phase 11 logits beside one rank: mesh fused vs one-rank fused calc_diff "
        f"{calc_diff(logits[0], one_fused):.3e}; mesh 'xla' vs one-rank unfused calc_diff "
        f"{calc_diff(l_xla, one_unfused):.3e}, bitwise {torch.equal(l_xla, one_unfused)} "
        f"(printed, not held: the capacities differ, 40 a rank's slot against 264 a slot at "
        f"one rank; on the mesh path's states the pairs dropped per layer, mesh / one rank: "
        f"{dropped} of {EP_BATCH_SHAPE[0] * EP_BATCH_SHAPE[1] * V3['topk']})")
    del one_fused, one_unfused, l_xla, l_pallas, logits, walked
    prof = profile_mesh(lambda: forward(sharded, batches[0], cfg_fused, mesh),
                        'forward over 8 ranks, mega fused', f'one {EP_BATCH_SHAPE} batch')
    return dict(numbers, profile=prof)


def phase_ep(seed, arch):
    """Phase 11; see the module docstring. Returns the JSON rows of #15,
    #12 and #14."""
    from deepgemm_tpu_torch.models.transformer import ModelConfig, init_params
    from deepgemm_tpu_torch.parallel import dist
    gen = torch.Generator(device='cuda').manual_seed(seed + 12)
    a2a = ep_a2a(gen, arch)
    t0 = time.perf_counter()
    params = init_params(ModelConfig(**V3), seed=seed + 11, device='cuda')
    torch.cuda.synchronize()
    mesh = dist.make_mesh([('dp', 1), ('ep', EP)], ['cuda:0'] * EP)
    log(f'phase 11 init: {time.perf_counter() - t0:.2f} s, '
        f'{torch.cuda.memory_allocated() / 1e9:.2f} GB of weights on the card; {mesh!r}, '
        f'{mesh.comm_blocks()} blocks a rank for the communicating kernels, spin timeout '
        f'{mesh.timeout} s')
    dispatch, dispatch_launches = ep_dispatch(mesh, params['layers'][0]['w1'], gen, arch)
    mega = ep_mega(mesh, params['layers'][0], gen, arch)
    # the forward on a mesh of its own: the checks' symmetric buffers freed
    del mesh
    torch.cuda.empty_cache()
    mesh = dist.make_mesh([('dp', 1), ('ep', EP)], ['cuda:0'] * EP)
    fwd = ep_forward(mesh, params, seed)
    del params, mesh
    torch.cuda.empty_cache()

    def row(name, source, replaces, launches, numbers, **extra):
        return dict(name=name, route='cuda', source=f'deepgemm_tpu_torch/csrc/{source}',
                    replaces=replaces, launches=launches, **numbers, **extra)

    return [
        row('a2a', 'a2a.cu', 'deepgemm_tpu/parallel/collectives.py:75', fwd['launches']['a2a'],
            a2a, path="the 8-rank forward under mega_comm='pallas'"),
        row('dispatch_gemm_fp8', 'mega_ep.cu', 'deepgemm_tpu/kernels/fused_moe.py:185',
            dispatch_launches['fp8'], dispatch['fp8'], path='its own entry point',
            bf16=dict(dispatch['bf16'], launches=dispatch_launches['bf16']),
            design=DISPATCH_DESIGN),
        row('mega_ep_moe', 'mega_ep.cu', 'deepgemm_tpu/kernels/fused_moe.py:1198',
            fwd['launches']['mega_ep'], mega, path="the 8-rank forward, mega_comm='fused'",
            forward=dict(tokens_per_s=fwd['tokens_per_s'], peak_gb=fwd['peak_gb'],
                         seconds=fwd['seconds'], profile=fwd['profile'])),
    ]


# The training step's dense, contiguous and k-grouped calls (phase 6's
# shapes: V3 widths, [2, 1024] tokens, 256 experts of 128 rows), for
# --gemm-times: (kind, name, shape, gran_n, output type).
TRAIN_GEMMS = (
    ('dense', 'qkv fwd', (2048, 49152, 7168), 128, torch.bfloat16),
    ('dense', 'o fwd', (2048, 7168, 16384), 128, torch.bfloat16),
    ('dense', 'o dgrad', (2048, 16384, 7168), 128, torch.bfloat16),
    ('dense', 'o wgrad', (7168, 16384, 2048), 1, torch.float32),
    ('dense', 'qkv dgrad', (2048, 7168, 49152), 128, torch.bfloat16),
    ('dense', 'qkv wgrad', (49152, 7168, 2048), 1, torch.float32),
    ('contiguous', 'L1 fwd', (32768, 4096, 7168, 256), 128, torch.bfloat16),
    ('contiguous', 'L2 fwd', (32768, 7168, 2048, 256), 128, torch.bfloat16),
    ('contiguous', 'L2 dgrad', (32768, 2048, 7168, 256), 128, torch.bfloat16),
    ('contiguous', 'L1 dgrad', (32768, 7168, 4096, 256), 128, torch.bfloat16),
    ('k_grouped', 'L2 wgrad', (7168, 2048, 32768, 256), None, torch.bfloat16),
    ('k_grouped', 'L1 wgrad', (4096, 7168, 32768, 256), None, torch.bfloat16),
)


def gemm_times(seed, arch):
    """--gemm-times: phase 3 and the training step's dense, contiguous and
    k-grouped calls at full shapes, then the MQA logits kernel's three
    calls of phase 7 (the prefill path's, the bench shape's e4m3, bf16 and
    register-A instances) and the two paged MQA entries at the decode shape, each
    timed (the kernel and, but for the paged entries, a bf16 PyTorch call;
    no plain version), for comparing two trees' kernels in one call."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    phase3 = phase_dense(gen, arch)
    results = {'dense': [], 'contiguous': [], 'k_grouped': []}
    for kind, name, shape, gran_n, out_dtype in TRAIN_GEMMS:
        rec = dict(name=name, shape=shape, out_dtype=out_dtype, err=float('nan'),
                   diff=float('nan'))
        if gran_n is not None:
            rec['gran_n'] = gran_n
        results[kind].append(rec)
    train = time_train_kernels(results, gen, arch, time_plain=False)
    torch.cuda.empty_cache()
    return dict(phase3=phase3, dense=train['dense'], contiguous=train['contiguous'],
                k_grouped=train['k_grouped'], relayout=train['relayout'],
                **mqa_times(seed, arch), bf16_forms=bf16_form_times(seed),
                masked=masked_times(seed))


def mqa_times(seed, arch):
    """--mqa-times (and part of --gemm-times): the MQA logits kernel's calls
    of :func:`mqa_calls` and the paged entries at the decode shape
    (:func:`paged_times`), each timed (no plain version)."""
    mqa = {label: time_mqa(label, call, arch, time_plain=False)
           for label, call in mqa_calls(seed).items()}
    return dict(mqa_logits=mqa, paged_mqa=paged_times(seed, arch))


def masked_times(seed):
    """--gemm-times: the masked kernel's calls, each timed: the decode's L1
    and L2 (phase 4's shapes, every row live) in fp8 and bf16 beside
    torch.bmm bf16, fp8_einsum bhr,hdr->bhd's call and its f32 instance
    (phase 9) beside torch.einsum bf16; then phase 10's planar FP4 B in the
    dense kernel at m 4096 beside the e4m3 kernel on its decoded codes."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense, grouped
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp4, repack_fp4_to_planar
    gen = torch.Generator(device='cuda').manual_seed(seed + 17)
    out = {}
    for label, shape, a, b, full, calls in masked_operands(gen):
        g, max_m, n, k = shape
        library_ms = bench_kernel(lambda: torch.bmm(a, b.transpose(1, 2)), iters=5)
        for kind, ops, kw in calls:
            ms = bench_kernel(lambda: grouped.masked_gemm(*ops, full, **kw), iters=5)
            out[f'{kind} {label}'] = dict(shape=shape, ms=ms, library_ms=library_ms)
            log(f'time masked {kind} {label} G={g} max_m={max_m} n={n} k={k}: kernel_ms={ms:.4f} '
                f'library_ms(torch.bmm bf16)={library_ms:.4f}')
        del a, b, calls
    x, w, ops, kw = einsum_operands(gen)
    library_ms = bench_kernel(lambda: torch.einsum('bhr,hdr->bhd', x, w), iters=20)
    h, tokens, r = ops[0].shape
    for label, dtype in (('fp8_einsum', torch.bfloat16), ('fp8_bmm f32', torch.float32)):
        ms = bench_kernel(lambda: grouped.masked_gemm(*ops, **kw, out_dtype=dtype), iters=20)
        out[label] = dict(shape=[h, tokens, w.shape[1], r], ms=ms, library_ms=library_ms)
        log(f'time masked {label} G={h} max_m={tokens} n={w.shape[1]} k={r}: '
            f'kernel_ms={ms:.4f} library_ms(torch.einsum bf16)={library_ms:.4f}')
    del x, w, ops, kw
    n, k, m = PLANAR_N, PLANAR_K, PLANAR_MS[-1]
    b = randn_bf16((n, k), gen, 1.0)
    b4, sf4 = per_token_cast_to_fp4(b, use_ue8m0=True)
    planar = repack_fp4_to_planar(b4)
    codes = dense._decode_planar(planar)
    aq, sfa = dgt.per_token_cast_to_fp8(randn_bf16((m, k), gen, 1.0), use_ue8m0=False)
    entry = dict(shape=[m, n, k],
                 ms=bench_kernel(lambda: dense.dense_gemm(aq, planar, sfa, sf4, gran_n=1,
                                                          fp4_b=True), iters=20),
                 e4m3_kernel_ms=bench_kernel(lambda: dense.dense_gemm(aq, codes, sfa, sf4,
                                                                      gran_n=1), iters=20))
    out[f'planar fp4 b m={m}'] = entry
    log(f'time planar FP4 B in the kernel m={m} n={n} k={k}: kernel_ms={entry["ms"]:.4f} '
        f'(e4m3 kernel on the codes {entry["e4m3_kernel_ms"]:.4f})')
    del b, b4, sf4, planar, codes, aq, sfa
    torch.cuda.empty_cache()
    return out


def bf16_form_times(seed):
    """--gemm-times: the dense forms on bf16 products (phase 10's shapes):
    'dequant' on packed UE8M0 scales, recipes (1, 1, 128) and (1, 128, 128),
    at 4096 x 4096 x 7168 and 128 x 4096 x 7168, beside 'promote' on the same
    operands; FP4 B at gran 32 (the mixed e4m3 x bf16 kernel on the folded B,
    and the op with its fold); each beside torch.matmul bf16."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.ops import sf_layout
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import decode_fp4_rows, per_token_cast_to_fp4
    gen = torch.Generator(device='cuda').manual_seed(seed + 13)
    out = {}
    for m, n, k in PACKED_SHAPES:
        a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
        aq, sfa_p = dgt.per_token_cast_to_fp8(a, use_ue8m0=True, use_packed_ue8m0=True)
        sfa = sf_layout.transform_sfa(sfa_p, m, k, 128)
        library_ms = bench_kernel(lambda: torch.matmul(a, b.t()), iters=20)
        for gran_n in (1, 128):
            cast = dgt.per_token_cast_to_fp8 if gran_n == 1 else dgt.per_block_cast_to_fp8
            bq, sfb = cast(b, use_ue8m0=True)
            kw = dict(gran_n=gran_n)
            entry = dict(shape=[m, n, k], library_ms=library_ms,
                         ms=bench_kernel(lambda: dense.dense_gemm(aq, bq, sfa, sfb,
                                                                  strategy='dequant', **kw),
                                         iters=20),
                         promote_ms=bench_kernel(lambda: dense.dense_gemm(aq, bq, sfa, sfb, **kw),
                                                 iters=20))
            out[f'dequant (1, {gran_n}, 128) {m}x{n}x{k}'] = entry
            log(f'time dequant recipe (1, {gran_n}, 128) m={m} n={n} k={k}: '
                f'kernel_ms={entry["ms"]:.4f} promote_ms={entry["promote_ms"]:.4f} '
                f'library_ms(torch.matmul bf16)={library_ms:.4f}')
        del a, b, aq, sfa, bq, sfb
    m, n, k = FP4_SHAPE
    a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
    aq, sfa = dgt.per_token_cast_to_fp8(a, use_ue8m0=False)
    b4 = per_token_cast_to_fp4(b, use_ue8m0=True, gran_k=32)
    folded = decode_fp4_rows(b4[0], b4[1], 32)
    entry = dict(shape=[m, n, k],
                 ms=bench_kernel(lambda: dense.dense_gemm(aq, folded, sfa, None), iters=20),
                 op_ms=bench_kernel(lambda: dgt.fp8_fp4_gemm_nt((aq, sfa), b4), iters=20),
                 library_ms=bench_kernel(lambda: torch.matmul(a, b.t()), iters=20))
    out[f'fp4 gran 32 {m}x{n}x{k}'] = entry
    log(f'time FP4 gran 32 m={m} n={n} k={k}: kernel_ms={entry["ms"]:.4f} op_ms(fold + kernel)='
        f'{entry["op_ms"]:.4f} library_ms(torch.matmul bf16)={entry["library_ms"]:.4f}')
    torch.cuda.empty_cache()
    return out


def decode_inputs(seed, q_dtype=torch.float8_e4m3fn, kv_dtype=torch.float8_e4m3fn):
    """The paged MQA entries' operands at the engine's decode shape on a
    seeded cache: 64 rows of next_n 1, 64 heads x 128, pages of 64 tokens in
    a shuffled block table, contexts of 4096-8192 tokens (phase 7's step-1
    shape; phase 7's data not needed). q and the cache e4m3 or bf16 (the
    bf16 instances' operands: the decoded FP4 values' types)."""
    from deepgemm_tpu_torch.kernels import paged_mqa
    from deepgemm_tpu_torch.utils.math import cast_to_fp8
    b, h, d, bkv, max_len = SERVE['max_slots'], SERVE['index_heads'], SERVE['index_dim'], 64, 8192
    g = torch.Generator(device='cuda').manual_seed(seed + 12)
    mb = max_len // bkv
    cast = lambda x, dt: cast_to_fp8(x) if dt == torch.float8_e4m3fn else x.to(dt)
    q = cast(torch.randn((b, 1, h, d), generator=g, device='cuda'), q_dtype)
    kv = cast(torch.randn((b * mb, bkv, d), generator=g, device='cuda'), kv_dtype)
    sf = torch.rand((b * mb, bkv), generator=g, device='cuda') + 0.5
    w = torch.randn((b, h), generator=g, device='cuda')
    ctx = torch.randint(4096, max_len + 1, (b,), generator=g, device='cuda', dtype=torch.int32)
    bt = torch.randperm(b * mb, generator=g, device='cuda').int().view(b, mb)
    hi = paged_mqa.row_bounds(ctx, 1)
    kv_lin, sf_lin = paged_mqa.linearise(kv, sf, bt)
    return dict(q=q, kv=kv, sf=sf, w=w, hi=hi, bt=bt, kv_lin=kv_lin, sf_lin=sf_lin,
                max_len=max_len, shape=[b, 1, h, d, max_len])


PAGED_PAIRS = {'e4m3': (torch.float8_e4m3fn, torch.float8_e4m3fn),
               'fp4_q_fp4_cache': (torch.bfloat16, torch.bfloat16),
               'fp4_q_e4m3_cache': (torch.bfloat16, torch.float8_e4m3fn),
               'e4m3_q_fp4_cache': (torch.float8_e4m3fn, torch.bfloat16)}


def paged_times(seed, arch):
    """--gemm-times: the paged MQA entries (#8 'gather', #9 'paged') at the
    engine's decode shape (:func:`decode_inputs`), the e4m3 instance and the
    three bf16 instances the FP4 pairs run: each call as testing/bench.py
    times it (ms), its device work with the host work hidden (device_ms),
    its host work (host_ms) and the part of that outside the C entry
    (python_host_ms: the same calls with the entry a no-op); torch.bmm bf16
    q x kv_lin^T beside them."""
    from deepgemm_tpu_torch.kernels import paged_mqa
    from deepgemm_tpu_torch.testing.bench import bench_host, bench_kernel
    own_entry = paged_mqa._entry

    def no_op(strategy):
        return own_entry(strategy)[0], lambda *args: 0

    out = {}
    for pair, (q_dtype, kv_dtype) in PAGED_PAIRS.items():
        x = decode_inputs(seed, q_dtype, kv_dtype)
        for name, fn in (('gather', lambda: paged_mqa.paged_mqa_logits_gather(
                             x['q'], x['kv_lin'], x['sf_lin'], x['w'], x['hi'], x['max_len'])),
                         ('paged', lambda: paged_mqa.paged_mqa_logits_paged(
                             x['q'], x['kv'], x['sf'], x['w'], x['hi'], x['bt'], x['max_len']))):
            key = name if pair == 'e4m3' else f'{name}_{pair}'
            rec = dict(ms=bench_kernel(fn, iters=20),
                       device_ms=bench_kernel(fn, iters=20, hide_host=True),
                       host_ms=bench_host(fn), shape=x['shape'], q=str(q_dtype),
                       kv=str(kv_dtype))
            paged_mqa._entry = no_op
            try:
                rec['python_host_ms'] = bench_host(fn)
            finally:
                paged_mqa._entry = own_entry
            out[key] = rec
            log(f'time paged MQA {key} [B, next_n, h, d, max_len = {x["shape"]}; q {q_dtype}, '
                f'cache {kv_dtype}]: kernel_ms={rec["ms"]:.4f} (the call, event-bracketed) '
                f'device_ms={rec["device_ms"]:.4f} (host work hidden) '
                f'host_ms={rec["host_ms"]:.4f} (of which outside the C entry '
                f'{rec["python_host_ms"]:.4f})')
        if pair == 'e4m3':
            b, _, h, d, _ = x['shape']
            q16, kv16 = x['q'].view(b, h, d).bfloat16(), x['kv_lin'].bfloat16()
            out['library_ms'] = bench_kernel(lambda: torch.bmm(q16, kv16.transpose(1, 2)),
                                             iters=10)
            del q16, kv16
        del x
    return out


# --variants: copies of csrc/gemm_sm90.cuh with one part of the contiguous
# kernel removed (its output is then wrong: only its time is read) or one
# setting changed, each edit a (text, replacement) that must match the
# source.
_BYTES = 'const uint32_t bytes = (kBM + b_tiles * kBN) * kBK +'
CONTIGUOUS_VARIANTS = {
    'no A loads': (('tma_load_2d(smem_a + s * kBM * kBK, ma, full + s, col0 + kb * kBK, it.m0);',
                    ''),
                   (_BYTES, 'const uint32_t bytes = (b_tiles * kBN) * kBK +')),
    'no B loads': (('tma_load_3d(sb, mb, full + s, kb * kBK, it.n0, it.b0);', ''),
                   ('tma_load_3d(sb, mb, full + s, it.n0, kb * kBK, it.b0);', ''),
                   ('tma_load_3d(sb + box * 64 * 128,', 'if (0) tma_load_3d(sb + box * 64 * 128,'),
                   (_BYTES, 'const uint32_t bytes = kBM * kBK +')),
    'no MMA': (('wgmma_e4m3(part[h], da + 2 * k, db + 2 * k, k);', ';'),
               ('wgmma_bf16<kBMn ? 1 : 0>(acc[h], da + 2 * k, db + (kBMn ? 128 : 2) * k, 1);',
                ';')),
    'no stores': (('tma_store_3d(&map_d, stage_out', 'if (0) tma_store_3d(&map_d, stage_out'),),
    'no transpose': (('transpose_b_stage(smem_b + s * kBN', 'if (0) transpose_b_stage(smem_b + s * kBN'),
                     ('transpose_b_stage(smem_b + s1 * kBN',
                      'if (0) transpose_b_stage(smem_b + s1 * kBN')),
    # not a part removed: the loads' L2 promotion at 128 bytes in place of 256
    'L2 promotion 128B': (('CU_TENSOR_MAP_L2_PROMOTION_L2_256B,', 'CU_TENSOR_MAP_L2_PROMOTION_L2_128B,'),),
}
VARIANT_STAGES = (3, 4, 8)      # ring caps for the package's own build (8: as many as fit)
# A timeline build: each block's producer lane and first consumer thread sum
# the clock64() cycles they spend waiting on the ring's barriers (the
# producer on a free stage, the consumer on a loaded one) beside the block's
# total, for one launch; read back through dgt_timeline_read.
TIMELINE_EDITS = (
    ('namespace sm90 {\n', 'namespace sm90 {\n__device__ long long timeline[1024][4];\n'),
    ('    extern __shared__ __align__(1024) uint8_t smem_raw[];\n',
     '    extern __shared__ __align__(1024) uint8_t smem_raw[];\n'
     '    const long long t_begin = clock64();\n    long long t_wait = 0;\n'),
    ('                mbar_wait(empty + s, phase ^ 1);\n',
     '                { const long long t0 = clock64(); mbar_wait(empty + s, phase ^ 1); '
     't_wait += clock64() - t0; }\n'),
    ('        return;\n    }\n\n    // ---- consumers',
     '        timeline[blockIdx.x][0] = t_wait;\n'
     '        timeline[blockIdx.x][1] = clock64() - t_begin;\n'
     '        return;\n    }\n\n    // ---- consumers'),
    ('\n            mbar_wait(full + s, phase);\n            uint8_t* sb_tile',
     '\n            { const long long t0 = clock64(); mbar_wait(full + s, phase); '
     't_wait += clock64() - t0; }\n            uint8_t* sb_tile'),
    ('    if (p.tma_store && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");\n}',
     '    if (threadIdx.x == 0) {\n        timeline[blockIdx.x][2] = t_wait;\n'
     '        timeline[blockIdx.x][3] = clock64() - t_begin;\n    }\n'
     '    if (p.tma_store && tid == 0) asm volatile("cp.async.bulk.wait_group 0;\\n" ::: "memory");\n}'),
)
TIMELINE_READER = """
extern "C" int dgt_timeline_read(void* out) {
    return static_cast<int>(cudaMemcpyFromSymbol(out, dgt::sm90::timeline,
                                                 sizeof(dgt::sm90::timeline)));
}
"""


def build_variants():
    """Each variant's contiguous library and the timeline build, compiled at
    once into the build directory; returns {name: its library}."""
    import ctypes
    import shutil
    from deepgemm_tpu_torch.runtime import build
    jobs = {}
    for name, edits in (*CONTIGUOUS_VARIANTS.items(), ('timeline', TIMELINE_EDITS)):
        d = build.build_dir() / 'variants' / name.replace(' ', '_')
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        text = (d / 'gemm_sm90.cuh').read_text()
        for old, new in edits:
            require(old in text, f'variant {name!r}: {old!r} is not in csrc/gemm_sm90.cuh')
            text = text.replace(old, new)
        if name == 'timeline':
            text += TIMELINE_READER
        (d / 'gemm_sm90.cuh').write_text(text)
        jobs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, '-o', str(d / 'lib.so'),
                                        str(d / 'contiguous.cu')], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), d / 'lib.so')
    libs = {}
    for name, (proc, out) in jobs.items():
        text, _ = proc.communicate()
        require(proc.returncode == 0, f'variant {name!r} does not build:\n{text[-3000:]}')
        lib = ctypes.CDLL(str(out))
        lib.dgt_contiguous_gemm.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 12 + [
            ctypes.c_void_p]
        lib.dgt_contiguous_gemm.restype = ctypes.c_int
        libs[name] = lib
    return libs


def timeline_shares(lib, fn):
    """One launch of ``fn`` through the timeline build: the shares of the
    blocks' cycles that their producers spent waiting for a free stage and
    their first consumer threads for a loaded one."""
    import ctypes
    fn()
    torch.cuda.synchronize()
    out = (ctypes.c_longlong * (1024 * 4))()
    require(lib.dgt_timeline_read(out) == 0, 'timeline: the read failed')
    rows = [out[4 * i:4 * i + 4] for i in range(1024)]
    rows = [r for r in rows if r[1] > 0 and r[3] > 0]
    return dict(blocks=len(rows),
                producer_waits_for_free_stage=sum(r[0] for r in rows) / sum(r[1] for r in rows),
                consumer_waits_for_loaded_stage=sum(r[2] for r in rows) / sum(r[3] for r in rows))


def variant_times(seed, rounds=3):
    """--variants: the contiguous kernel at the training step's L1 forward
    (256 experts of 128 rows; fp8 NT, bf16 NT, fp8 NN) and on phase 9's
    uneven layout (bf16 NT), its own build at each ring cap and each variant
    build at the default cap, all in turns for ``rounds`` rounds (ms, the
    mean of 10 L2-flushed launches each); then one launch of the timeline
    build (the ring's waits)."""
    import functools
    from deepgemm_tpu_torch.heuristics import configs
    from deepgemm_tpu_torch.kernels import grouped
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import per_token_cast_to_fp8, quantize_experts
    libs = build_variants()
    timeline = libs.pop('timeline')
    entries = {name: lib.dgt_contiguous_gemm for name, lib in libs.items()}
    own_entry, own_chooser = grouped._contiguous_entry, grouped.get_sm90_config
    default_cap = configs.CONTIGUOUS_MAX_STAGES

    def use(entry, cap):
        grouped._contiguous_entry = (lambda: entry) if entry is not None else own_entry
        grouped.get_sm90_config = functools.partial(configs.get_sm90_config, max_stages=cap)

    configurations = [(f'stages<={cap}', None, cap) for cap in VARIANT_STAGES]
    configurations += [(name, entry, default_cap) for name, entry in entries.items()]
    gen = torch.Generator(device='cuda').manual_seed(seed)
    g, (n, k) = DUAL_EXPERTS, DUAL_SHAPES[0][1:]
    uniform = torch.arange(g, dtype=torch.int32, device='cuda').repeat_interleave(128)
    uneven = dual_layout(seed)[0]
    results = {}
    try:
        for layout, ids in (('uniform', uniform), ('uneven', uneven)):
            m = ids.numel()
            a = randn_bf16((m, k), gen, 1.0)
            b = randn_bf16((g, n, k), gen, k ** -0.5)
            cases = {'bf16 nt': lambda: grouped.contiguous_gemm(a, b, ids)}
            if layout == 'uniform':
                aq, sfa = per_token_cast_to_fp8(a, use_ue8m0=False)
                bq, sfb = quantize_experts(b)
                bq_mn = bq.view(torch.uint8).transpose(1, 2).contiguous().view(bq.dtype)
                cases['fp8 nt'] = lambda: grouped.contiguous_gemm(aq, bq, ids, sfa=sfa, sfb=sfb)
                cases['fp8 nn'] = lambda: grouped.contiguous_gemm(aq, bq_mn, ids, sfa=sfa, sfb=sfb,
                                                                  b_mn=True)
            for case, fn in cases.items():
                times = {}
                for _ in range(rounds):
                    for label, entry, cap in configurations:
                        use(entry, cap)
                        times.setdefault(label, []).append(bench_kernel(fn, iters=10))
                use(timeline.dgt_contiguous_gemm, default_cap)
                shares = timeline_shares(timeline, fn)
                results[f'{layout} {case}'] = dict(times, timeline=shares)
                log(f'variants {layout} {case} m={m} n={n} k={k}: ' + ' '.join(
                    f'{label}={min(v):.4f}/{max(v):.4f}' for label, v in times.items()) +
                    f'; timeline {shares}')
            del a, b, cases
            torch.cuda.empty_cache()
    finally:
        grouped._contiguous_entry, grouped.get_sm90_config = own_entry, own_chooser
    return results


# --mqa-variants: copies of csrc/mqa_sm90.cuh with parts of the MQA logits
# kernel removed (the output is then wrong: only the time is read), each edit
# a (text, replacement) that must match the source.
_MQA_HEAD_SUM = ('                            s0[h] = fmaf(fmaxf(a[0], 0.f), w0, s0[h]);\n'
                 '                            s1[h] = fmaf(fmaxf(a[1], 0.f), w1, s1[h]);\n'
                 '                            s2[h] = fmaf(fmaxf(a[2], 0.f), w0, s2[h]);\n'
                 '                            s3[h] = fmaf(fmaxf(a[3], 0.f), w1, s3[h]);', '')
_MQA_NO_MMA = ('sm90::wgmma_e4m3(acc[u], desc(a), desc(b), k);', ';')
_MQA_NO_STORE = ('                if (c < p.out_cols)\n                    p.out[static_cast<int64_t>(g.row0 + rq)',
                 '                if (c < 0)\n                    p.out[static_cast<int64_t>(g.row0 + rq)')
_MQA_NO_LOADS = (('const uint32_t kv_bytes =\n'
                  '                    n_kv_boxes * kRows * 128 + (sf_tma ? (p.sf_box << ksh) * 4 : 0);',
                  'const uint32_t kv_bytes = 0;'),
                 ('sm90::tma_load_2d(kv_s', 'if (0) sm90::tma_load_2d(kv_s'),
                 ('tma_load_1d(sf_s', 'if (0) tma_load_1d(sf_s'))
MQA_VARIANTS = {
    'no MMA': (_MQA_NO_MMA,),
    'no head sum': (_MQA_HEAD_SUM,),
    'MMA only': (_MQA_HEAD_SUM, _MQA_NO_STORE),
    'skeleton': (_MQA_NO_MMA, _MQA_HEAD_SUM, _MQA_NO_STORE) + _MQA_NO_LOADS,
}
# the paged entries' decode call: on e4m3 wgmma (not widened to bf16), the
# same parts removed, then the pipeline alone with the loads (no wgmma, head
# sum or stores), then the run chooser aiming at other item counts an SM
_ITEMS = 'constexpr int kPagedItemsPerSm = 4;'
_EXACT = '__host__ __device__ constexpr bool exact_e4m3(Source s) { return s == Source::kPaged; }'
_MQA_NO_RS = ('if (k < steps) wgmma_bf16_rs(acc[u], a[v], db + ob, k);', ';')
PAGED_VARIANTS = {
    'e4m3 wgmma': ((_EXACT, _EXACT.replace('s == Source::kPaged', 'false')),),
    'no MMA': (_MQA_NO_MMA, _MQA_NO_RS),
    'no head sum': (_MQA_HEAD_SUM,),
    'pipeline only': (_MQA_NO_MMA, _MQA_NO_RS, _MQA_HEAD_SUM, _MQA_NO_STORE),
    'skeleton': (_MQA_NO_MMA, _MQA_NO_RS, _MQA_HEAD_SUM, _MQA_NO_STORE) + _MQA_NO_LOADS,
    'items 2 an SM': ((_ITEMS, _ITEMS.replace('4;', '2;')),),
    'items 8 an SM': ((_ITEMS, _ITEMS.replace('4;', '8;')),),
    'items 16 an SM': ((_ITEMS, _ITEMS.replace('4;', '16;')),),
}


def variant_entries(label, header, source, variants, symbol, own):
    """{'kernel': own, name: C entry} for copies of csrc/ with each variant's
    (text, replacement) edits to ``header``, ``source`` built from each copy
    (all compiled at once, into the build directory's ``label``)."""
    import ctypes
    import shutil
    from deepgemm_tpu_torch.runtime import build
    jobs = {}
    for name, edits in variants.items():
        d = build.build_dir() / label / name.replace(' ', '_')
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        text = (d / header).read_text()
        for old, new in edits:
            require(old in text, f'{label} {name!r}: {old!r} is not in csrc/{header}')
            text = text.replace(old, new)
        (d / header).write_text(text)
        jobs[name] = (subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, '-o', str(d / 'lib.so'),
                                        str(d / source)], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), d / 'lib.so')
    entries = {'kernel': own}
    for name, (proc, out) in jobs.items():
        text, _ = proc.communicate()
        require(proc.returncode == 0, f'{label} {name!r} does not build:\n{text[-3000:]}')
        fn = getattr(ctypes.CDLL(str(out)), symbol)
        fn.argtypes, fn.restype = own.argtypes, own.restype
        entries[name] = fn
    return entries


def mqa_variant_times(seed, arch, rounds=3):
    """--mqa-variants: the MQA logits kernel's e4m3 calls of phase 7 (the
    prefill path's and the bench shape's) through its own build and through
    each MQA_VARIANTS build, then the paged gather entry's decode call
    (:func:`decode_inputs`, e4m3) through its own build and each
    PAGED_VARIANTS build (all compiled at once), each in turns for
    ``rounds`` rounds (ms, the mean of 10 L2-flushed launches each; the
    decode's on the device with the host's work hidden, bench_kernel's
    hide_host): what bounds them."""
    from deepgemm_tpu_torch.kernels import mqa_logits, paged_mqa
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    own = mqa_logits._entry()
    own_lib, own_paged = paged_mqa._entry('gather')
    entries = variant_entries('mqa_variants', 'mqa_sm90.cuh', 'mqa_logits.cu', MQA_VARIANTS,
                              'dgt_mqa_logits', own)
    paged_entries = variant_entries('paged_variants', 'mqa_sm90.cuh', 'paged_mqa.cu',
                                    PAGED_VARIANTS, 'dgt_paged_mqa_logits_gather', own_paged)
    calls = mqa_calls(seed)
    results = {}
    try:
        for label in ('path', 'bench'):
            q, kv, sf, w, lo, hi = calls[label]
            times = {}
            for _ in range(rounds):
                for name, fn in entries.items():
                    mqa_logits._entry = lambda fn=fn: fn
                    times.setdefault(name, []).append(
                        bench_kernel(lambda: mqa_logits.mqa_logits(q, kv, w, lo, hi, kv_sf=sf)))
            results[label] = times
            log(f'mqa variants {label} [sq={q.shape[0]} skv={kv.shape[0]} h={q.shape[1]} '
                f'd={q.shape[2]}]: ' + ' '.join(f'{name}={min(v):.4f}/{max(v):.4f}'
                                                for name, v in times.items()))
    finally:
        mqa_logits._entry = lambda: own
    x = decode_inputs(seed)
    times, own_entry = {}, paged_mqa._entry
    try:
        for _ in range(rounds):
            for name, fn in paged_entries.items():
                paged_mqa._entry = lambda strategy, fn=fn: (own_lib, fn)
                times.setdefault(name, []).append(bench_kernel(
                    lambda: paged_mqa.paged_mqa_logits_gather(x['q'], x['kv_lin'], x['sf_lin'],
                                                              x['w'], x['hi'], x['max_len']),
                    iters=10, hide_host=True))
    finally:
        paged_mqa._entry = own_entry
    results['decode'] = times
    log(f'mqa variants decode (paged gather entry) [B, next_n, h, d, max_len = {x["shape"]}]: '
        + ' '.join(f'{name}={min(v):.4f}/{max(v):.4f}' for name, v in times.items()))
    return results


# --widen-variants: copies of csrc/gemm_sm90.cuh with one part of widen_kernel
# (the dense forms on bf16 products) removed; its output is then wrong, only
# its time is read.
_WIDEN_A = tuple((f'af[v][{e}] = mul_bf16x2(e4m3x2_bits({x}, {y}, sel), c1[{e & 1}]);',
                  f'af[v][{e}] = {x};')
                 for e, x, y in ((0, 'x.x', 'x.y'), (1, 'y.x', 'y.y'), (2, 'x.z', 'x.w'),
                                 (3, 'y.z', 'y.w')))
WIDEN_VARIANTS = {
    'no B widening': (('            widen_b(s);\n', '\n'), ('                    widen_b(s1);\n', '\n')),
    'no A widening': _WIDEN_A,
    'no wgmma': (('wgmma_bf16_rs(d, af[v], db_v, kOneSum || v > 0);', 'fence_all(d);'),),
}


def widen_variant_times(seed, rounds=3):
    """--widen-variants: 'dequant' at 4096 x 4096 x 7168 (recipes (1, 1, 128)
    and (1, 128, 128), UE8M0 scales) and the FP4 gran 32 kernel (the mixed
    e4m3 x bf16 'promote' form on the folded B) through the widening
    kernel's own build and each WIDEN_VARIANTS build, all in turns for
    ``rounds`` rounds (ms, the mean of 10 L2-flushed launches each): what
    bounds it."""
    import deepgemm_tpu_torch as dgt
    from deepgemm_tpu_torch.kernels import dense
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    from deepgemm_tpu_torch.utils.math import decode_fp4_rows, per_token_cast_to_fp4
    own = dense._bf16_mma_entry()
    entries = variant_entries('widen_variants', 'gemm_sm90.cuh', 'dense_dequant.cu',
                              WIDEN_VARIANTS, 'dgt_dense_gemm_bf16_mma', own)
    gen = torch.Generator(device='cuda').manual_seed(seed + 14)
    m, n, k = FP4_SHAPE
    a, b = randn_bf16((m, k), gen, 1.0), randn_bf16((n, k), gen, 1.0)
    aq, sfa = dgt.per_token_cast_to_fp8(a, use_ue8m0=True)
    b1, sb1 = dgt.per_token_cast_to_fp8(b, use_ue8m0=True)
    b128, sb128 = dgt.per_block_cast_to_fp8(b, use_ue8m0=True)
    folded = decode_fp4_rows(*per_token_cast_to_fp4(b, use_ue8m0=True, gran_k=32), 32)
    calls = {'dequant (1, 1, 128)': lambda: dense.dense_gemm(aq, b1, sfa, sb1, gran_n=1,
                                                             strategy='dequant'),
             'dequant (1, 128, 128)': lambda: dense.dense_gemm(aq, b128, sfa, sb128,
                                                               strategy='dequant'),
             'fp4 gran 32': lambda: dense.dense_gemm(aq, folded, sfa, None)}
    results = {}
    try:
        for label, call in calls.items():
            times = {}
            for _ in range(rounds):
                for name, fn in entries.items():
                    dense._bf16_mma_entry = lambda fn=fn: fn
                    times.setdefault(name, []).append(bench_kernel(call))
            results[label] = times
            log(f'widen variants {label} [{m}x{n}x{k}]: ' +
                ' '.join(f'{name}={min(v):.4f}/{max(v):.4f}' for name, v in times.items()))
    finally:
        dense._bf16_mma_entry = lambda: own
    return results


MASKED_VARIANT_STAGES = (2, 3, 4, 8)
# The masked body without its wgmma (csrc/gemm_sm90.cuh widen_body, which
# the dense forms on bf16 products share): the loads, the widening, the
# promotion and the stores alone.
MASKED_NO_MMA = WIDEN_VARIANTS['no wgmma'] + (
    ('wgmma_bf16<0>(d, smem_desc(a_box) + (v & 3) * 2, db_v, 1);', 'fence_all(d);'),)


def masked_variant_times(seed, rounds=2):
    """--masked-variants: the masked kernel's decode calls (phase 4's L1 and
    L2, fp8 and bf16; ms, L2-flushed) and fp8_einsum's call, then #12 at
    V3's L1 on 8 ranks (fp8 and bf16; the kernel's device ms, least over
    the ranks), each at every ring cap of MASKED_VARIANT_STAGES and as a
    build without the wgmma at the default cap, all in turns for
    ``rounds`` rounds: what bounds them and the ring they want."""
    import functools
    import types
    from deepgemm_tpu_torch.heuristics import configs
    from deepgemm_tpu_torch.kernels import fused_moe, grouped
    from deepgemm_tpu_torch.parallel import dist
    from deepgemm_tpu_torch.testing.bench import bench_kernel
    own_entry, own_ep_lib = grouped._entry, fused_moe._ep_lib
    own_choosers = grouped.get_sm90_config, fused_moe.get_sm90_config
    no_mma = {'no wgmma': MASKED_NO_MMA}
    masked = variant_entries('masked_variants', 'gemm_sm90.cuh', 'masked.cu', no_mma,
                             'dgt_masked_gemm_nt', own_entry())['no wgmma']
    ep_lib = own_ep_lib()
    dispatch = variant_entries('masked_variants_ep', 'gemm_sm90.cuh', 'mega_ep.cu', no_mma,
                               'dgt_dispatch_gemm', ep_lib.dgt_dispatch_gemm)['no wgmma']
    ep_variant = types.SimpleNamespace(dgt_dispatch_gemm=dispatch,
                                       dgt_error_string=ep_lib.dgt_error_string)

    def use(cap, variant=False):
        grouped.get_sm90_config = fused_moe.get_sm90_config = functools.partial(
            configs.get_sm90_config, max_stages=cap)
        grouped._entry = (lambda: masked) if variant else own_entry
        fused_moe._ep_lib = (lambda: ep_variant) if variant else own_ep_lib

    configurations = [(f'stages<={cap}', cap, False) for cap in MASKED_VARIANT_STAGES]
    configurations.append(('no wgmma', configs.MASKED_MAX_STAGES, True))
    gen = torch.Generator(device='cuda').manual_seed(seed + 23)
    times = {}

    def note(key, ms):
        times.setdefault(key, []).append(ms)
        log(f'masked variants {key}: {ms:.4f}')

    try:
        for label, _, _, _, full, calls in masked_operands(gen):
            for _ in range(rounds):
                for name, cap, variant in configurations:
                    use(cap, variant)
                    for kind, ops, kw in calls:
                        note(f'{kind} {label} {name}', bench_kernel(
                            lambda: grouped.masked_gemm(*ops, full, **kw), iters=5))
            del calls
        _, _, ops, kw = einsum_operands(gen)
        for _ in range(rounds):
            for name, cap, variant in configurations:
                use(cap, variant)
                note(f'fp8_einsum {name}', bench_kernel(lambda: grouped.masked_gemm(*ops, **kw),
                                                        iters=20))
        del ops, kw
        torch.cuda.empty_cache()
        hidden, n = V3['hidden'], V3['moe_intermediate'] * 2
        mesh = dist.make_mesh([('dp', 1), ('ep', EP)], ['cuda:0'] * EP)
        w = randn_bf16((EP * EP_EXPERTS, n, hidden), gen, hidden ** -0.5)
        call, _, cases = dispatch_operands(w, gen)
        for _ in range(rounds):
            for name, cap, variant in configurations:
                use(cap, variant)
                for kind, args in cases:
                    device = kernel_device_ms(mesh, call, args, 'dispatch_gemm_kernel')
                    note(f'dispatch_gemm {kind} {name} (device)', device[0])
        del w, cases
        torch.cuda.empty_cache()
    finally:
        grouped.get_sm90_config, fused_moe.get_sm90_config = own_choosers
        grouped._entry, fused_moe._ep_lib = own_entry, own_ep_lib
    return {key: dict(min=min(v), max=max(v)) for key, v in times.items()}


def ep_times(seed):
    """--ep-times: phase 11's main path alone (:func:`ep_main_path`, then one
    batch under the profiler: wall time and the device's idle share), for
    comparing two trees' end-to-end numbers in one call."""
    from deepgemm_tpu_torch.models.transformer import ModelConfig, forward, init_params
    from deepgemm_tpu_torch.parallel import dist
    params = init_params(ModelConfig(**V3), seed=seed + 11, device='cuda')
    mesh = dist.make_mesh([('dp', 1), ('ep', EP)], ['cuda:0'] * EP)
    sharded, batches, cfg_fused, logits, numbers = ep_main_path(mesh, params, seed)
    del logits
    prof = profile_mesh(lambda: forward(sharded, batches[0], cfg_fused, mesh),
                        'forward over 8 ranks, mega fused', f'one {EP_BATCH_SHAPE} batch')
    del sharded, batches
    torch.cuda.empty_cache()
    dispatch = dispatch_times(mesh, params['layers'][0]['w1'], seed)
    return dict(numbers, profile=prof, dispatch_gemm=dispatch)


def dispatch_times(mesh, w, seed):
    """--ep-times: #12 alone at V3's L1 on the 8 ranks (phase 11's shapes),
    fp8 and bf16, each timed (no checks, no plain version)."""
    gen = torch.Generator(device='cuda').manual_seed(seed + 19)
    e_local, cap, hidden = EP_EXPERTS, EP_CAP, V3['hidden']
    call, send, cases = dispatch_operands(w, gen)
    out = {}
    for kind, args in cases:
        ms = mesh_bench(mesh, call, args, iters=5)
        device = kernel_device_ms(mesh, call, args, 'dispatch_gemm_kernel')
        out[kind] = dict(ms=ms, device_ms=device, shape=[EP, e_local, cap, w.shape[1], hidden])
        log(f'time dispatch_gemm {kind} [8 ranks, E_local {e_local}, cap {cap}, N {w.shape[1]}, '
            f'H {hidden}]: kernel_ms={ms:.4f} (the call, event-bracketed); under the profiler '
            f'the kernel\'s device ms over the ranks, least / most / the call\'s other device ops '
            f'summed: {device}')
    del send, cases
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--gemm-times', action='store_true',
                        help='only build and time phase 3, the training step\'s dense, '
                             'contiguous and k-grouped calls and phase 7\'s MQA logits calls '
                             '(no plain versions), then print them as JSON')
    parser.add_argument('--mqa-times', action='store_true',
                        help='only build and time the MQA logits calls and the paged MQA '
                             'entries of --gemm-times, then print them as JSON')
    parser.add_argument('--ep-times', action='store_true',
                        help='only build and run phase 11\'s main path (the 8-rank forward, '
                             'timed and profiled), then print its numbers as JSON')
    parser.add_argument('--variants', action='store_true',
                        help='only build and time the contiguous kernel against its variant '
                             'builds and ring caps (what bounds it), then print them as JSON')
    parser.add_argument('--mqa-variants', action='store_true',
                        help='only build and time the MQA logits kernel against its variant '
                             'builds (what bounds it), then print them as JSON')
    parser.add_argument('--masked-variants', action='store_true',
                        help='only build and time the masked kernel and the fused dispatch + L1 '
                             'at each ring cap and without their wgmma (what bounds them), then '
                             'print them as JSON')
    parser.add_argument('--widen-variants', action='store_true',
                        help='only build and time the dense forms on bf16 products against '
                             'their variant builds (what bounds them), then print them as JSON')
    parser.add_argument('--package-root', default=os.path.dirname(os.path.abspath(__file__)),
                        help='the directory that holds the deepgemm_tpu_torch to run (default: '
                             'the one beside this script)')
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.package_root))
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
    if args.gemm_times:
        print(json.dumps({'gemm_times': gemm_times(args.seed, H100_SXM),
                          'package': os.path.abspath(args.package_root)}, default=str))
        print(card)
        return 0
    if args.mqa_times:
        print(json.dumps({'mqa_times': mqa_times(args.seed, H100_SXM),
                          'package': os.path.abspath(args.package_root)}, default=str))
        print(card)
        return 0
    if args.ep_times:
        print(json.dumps({'ep_times': ep_times(args.seed),
                          'package': os.path.abspath(args.package_root)}, default=str))
        print(card)
        return 0
    if args.mqa_variants:
        print(json.dumps({'mqa_variants': mqa_variant_times(args.seed, H100_SXM)}))
        print(card)
        return 0
    if args.masked_variants:
        print(json.dumps({'masked_variants': masked_variant_times(args.seed)}))
        print(card)
        return 0
    if args.widen_variants:
        print(json.dumps({'widen_variants': widen_variant_times(args.seed)}))
        print(card)
        return 0
    if args.variants:
        print(json.dumps({'variants': variant_times(args.seed)}))
        print(card)
        return 0
    gen = torch.Generator(device='cuda').manual_seed(args.seed)
    dense_entries = phase_dense(gen, H100_SXM)
    torch.cuda.synchronize()
    masked = phase_masked(gen, H100_SXM)
    torch.cuda.synchronize()
    counts = phase_forward(args.seed)
    torch.cuda.synchronize()
    train, train_counts = phase_train(args.seed, H100_SXM)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    served = phase_serve(args.seed, H100_SXM)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pallas = phase_serve_pallas(args.seed, H100_SXM, served)
    del served['outs']
    torch.cuda.synchronize()
    prefill, prefill_counts = phase_prefill(args.seed, H100_SXM)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mega, mega_launches = phase_mega(args.seed, H100_SXM)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    entry_rows = phase_entry_points(args.seed, gen, H100_SXM)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    surface_rows = phase_surface(args.seed, gen, H100_SXM)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ep_rows = phase_ep(args.seed, H100_SXM)
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
               train_counts['dense'], train['dense'], design=HOPPER_DESIGN,
               phase3_shapes=dense_entries),
        *(kernel(f'masked_grouped_gemm_{kind}', 'masked.cu',
                 'deepgemm_tpu/kernels/grouped.py:576', counts[kind], masked[kind],
                 design=MASKED_DESIGN)
          for kind in ('bf16', 'fp8')),
        kernel('contiguous_grouped_gemm_fp8', 'contiguous.cu',
               'deepgemm_tpu/kernels/grouped.py:240', train_counts['contiguous'],
               train['contiguous'], design=CONTIGUOUS_DESIGN,
               forms=train_counts['contiguous_forms']),
        kernel('k_grouped_gemm_fp8', 'k_grouped.cu', 'deepgemm_tpu/kernels/k_grouped.py:237',
               train_counts['k_grouped'], train['k_grouped'], design=HOPPER_DESIGN,
               relayout_ms=sum(e['relayout_ms'] for e in train['k_grouped'])),
        # the FP8 k-grouped wrapper's TN relayout, one launch an operand
        # (JAX's wrapper transposes its operands in XLA, k_grouped.py:438-440)
        kernel('k_major_relayout', 'relayout.cuh', 'deepgemm_tpu/kernels/k_grouped.py:438',
               train_counts['relayout'], train['relayout'],
               design='one transposing gather, 128 x 128-byte tiles'),
    ]
    # phase 7: the MQA logits kernel's numbers are the prefill path's call,
    # with the JAX bench's prefill shape beside; the others are the decode
    # path's (the zero-copy entry: its own path on step 1's cache)
    timing, errors = served['timing'], served['errors']

    def indexer_kernel(name, source, replaces, launches, err, entry, **extra):
        return dict(name=name, route='cuda', source=f'deepgemm_tpu_torch/csrc/{source}',
                    replaces=replaces, launches=launches, max_abs_err=err, **entry, **extra)

    kernels += [
        indexer_kernel('mqa_logits', 'mqa_logits.cu', 'deepgemm_tpu/kernels/mqa_logits.py:133',
                       prefill_counts['mqa'], prefill['path']['max_abs_err'],
                       {k: v for k, v in prefill['path'].items() if k != 'max_abs_err'},
                       bench_shape=prefill['bench'], design=MQA_DESIGN),
        indexer_kernel('paged_mqa_logits_gather', 'paged_mqa.cu',
                       'deepgemm_tpu/kernels/paged_mqa.py:166', served['counts']['gather'],
                       errors['paged'][1], timing['gather'], design=PAGED_DESIGN,
                       instance=served['instance'],
                       selections_differ=served['selections_differ']),
        indexer_kernel('paged_mqa_logits_paged', 'paged_mqa.cu',
                       'deepgemm_tpu/kernels/paged_mqa.py:382', served['zc_launches'],
                       errors['zero_copy'][1], timing['paged'], design=PAGED_DESIGN),
        indexer_kernel('sparse_attention', 'sparse_attn.cu',
                       'deepgemm_tpu/kernels/sparse_attn.py:104', served['counts']['attn'],
                       errors['attn'][1], timing['attn'], prefill_launches=prefill_counts['attn']),
        # the gather-fused attention: launches are the decode's under pallas
        indexer_kernel('sparse_attention_paged', 'sparse_attn.cu',
                       'deepgemm_tpu/kernels/sparse_attn.py:274', pallas['counts']['fused'],
                       pallas['fused']['max_abs_err'],
                       {k: v for k, v in pallas['fused'].items() if k != 'max_abs_err'}),
        # the bf16 instances (FP4 operands decoded): launches are their own
        # paths' (the FP4 op calls)
        indexer_kernel('mqa_logits_bf16', 'mqa_logits.cu', 'deepgemm_tpu/kernels/mqa_logits.py:133',
                       prefill['bench_fp4']['launches'], prefill['bench_fp4']['max_abs_err'],
                       {k: v for k, v in prefill['bench_fp4'].items()
                        if k not in ('max_abs_err', 'launches')}, design=MQA_DESIGN),
        *(indexer_kernel(f'paged_mqa_logits_{entry}_bf16', 'paged_mqa.cu', replaces,
                         pallas['fp4_launches'][entry],
                         max(v[entry]['max_abs_err'] for v in pallas['fp4'].values()),
                         {k: v for k, v in pallas['fp4']['fp4_q_fp4_cache'][entry].items()
                          if k != 'max_abs_err'},
                         pairs={label: v[entry] for label, v in pallas['fp4'].items()})
          for entry, replaces in (('gather', 'deepgemm_tpu/kernels/paged_mqa.py:166'),
                                  ('paged', 'deepgemm_tpu/kernels/paged_mqa.py:382'))),
    ]
    # phase 8: the main path's instance (fp8 weights, bf16 act) with the
    # other four beside it; launches are the default forward's
    kernels.append(dict(name='mega_local_moe', route='cuda',
                        source='deepgemm_tpu_torch/csrc/mega_local.cu',
                        replaces='deepgemm_tpu/kernels/fused_moe.py:690',
                        launches=mega_launches['fp8'],
                        act_fp8_forward_launches=mega_launches['fp8_act_fp8'],
                        **mega['fp8'], modes=mega))
    # phases 9 and 10: each entry point's call is its own path
    kernels += entry_rows + surface_rows
    # phase 11: #15 and #14 from the 8-rank forward, #12 from its own path
    kernels += ep_rows
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
