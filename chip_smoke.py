#!/usr/bin/env python3
"""GPU smoke test of stable_ts_tpu_torch: builds the CUDA kernels, holds
each against its plain PyTorch twin, then drives the paths on Whisper
large-v3 (random bf16 weights from a seed, the canonical alignment heads,
a synthetic rank table the size of the multilingual vocabulary) through
``WhisperTorch.transcribe`` and ``transcribe_batched``, and the train
step:

- step graph (``step_graph_checks``): the greedy step's CUDA graph at
  the main path's shapes: the device-position self entry and the indirect
  cross entry against their twins and bit for bit against the int and
  direct entries, then a replayed 32-row greedy group whose profile must
  show those two kernel instantiations once a layer a replay, equal to
  the eager group bit for bit;
- greedy: 75 s and 20 s with language='en', temperature=0 (the logit
  epilogue on every step);
- beam: 20 s with no language (detect_language) and beam_size=5 (the vocab
  projection on every step);
- ladder: 30 s on temperature=(0.0, 0.4, 0.8) with best_of=5 (random
  weights fail every rung, so every rung runs);
- align: ``model.align`` of the greedy 20-s request's own transcript on
  its clip (which must launch flash and the DTW), its wall and seconds per
  audio second beside that request's; then ``model.align_words`` over a
  60-s grid of 10-s segments at 2.2 words a second: with ``parallel`` at
  its default on the card it must make one encoder and one capture pass
  (exactly 64 flash launches) and exactly one DTW launch for the six
  segments, with ``parallel=False`` six times 64 flash and one DTW; the
  two must give the same words in the same order (their largest time
  difference is logged, not gated);
- locate: ``model.locate`` of the first 4 tokens of the greedy 75-s
  transcript in its clip: mode 2 (flash), modes 1 and 0 with
  ``probability_threshold=0.0`` so that the confirmation decode forces
  the target (the self and cross decode entries over float caches and
  ``vocab_proj``; mode 0 also the DTW), and a mode-1 request whose fourth
  token is a suppressed one at ``probability_threshold=1e-30``, which
  must roll the decode back and re-prefill; each wall beside the greedy
  75-s request's;
- no heads: the same weights with no known alignment heads, 10 s greedy
  with language='en' (6 heads selected per token from the full capture);
- checkpoint: the same weights written as an OpenAI ``large-v3.pt``
  (``save_openai_checkpoint``) beside a ``multilingual.tiktoken`` of the
  rank table, loaded back by ``load_model(path, dtype=torch.bfloat16)``;
  every parameter, the heads the file name resolves to and the
  vocabulary must be the sources';
- new aligner: on the loaded model, 10 s greedy with the legacy aligner
  and known heads, then with aligner='new' (every head scored on the
  card), with each request's word-timing time and peak device memory;
- extra models: the same legacy request with a second large-v3 (seed 1)
  in ``extra_models``, which must add its 32 encoder and 32 capture-pass
  flash launches a window; then one window's encoder and 'new' aligner
  pass under ``profiling.profile_trace``, whose Chrome trace must name the
  flash and DTW kernels;
- cli: on that ``large-v3.pt``, ``python -m stable_ts_tpu_torch`` as a
  subprocess on the 20-s clip as a 16-bit WAV (``--dtype bfloat16
  --language en``, all six formats, the default fallback ladder): exit 0,
  six non-empty files, SRT bytes equal to the same argv run in this
  process (walls logged: the subprocess's start-up, imports, build check
  and load beside the in-process request's); then, in this process on one
  model kept by ``_run_once``'s cache, ``transcribe_batched`` with
  ``batch_size=8`` on a 120-s WAV, ``--align`` of the 20-s TXT output,
  ``--align_words`` of the batched JSON, ``--refine`` of that alignment,
  ``--locate`` of the first 4 tokens of the 20-s transcript and ``-dq``
  greedy (a second load), each with its launch counts reset and read and
  the kernels of its entry point required; a JSON -> SRT request must
  launch nothing and load no model;
- batched: ``WhisperTorch.transcribe_batched`` on 300 s of the same
  signal: greedy over 10 windows in groups of 8 (a full group and a group
  of 2 padded to 8), which must launch 64 flash kernels (32 encoder and 32
  capture-pass layers) and one DTW a group; beam_size=5 over 90 s in a
  group of 4 with no language; the temperature ladder with best_of=5 over
  60 s in a group of 2, which must encode once; 60 s with no known heads
  and dynamic_heads='6,2' (two DTW launches a group); 60 s with
  aligner='new'; a warning that the batch was halved or capped fails the
  run. Each request logs its wall, steps, ms a step, rows a step, the
  driver's HOST_PHASES and its peak device memory, and one line compares
  the batched greedy's seconds per audio second with the sequential
  greedy 75 s's;
- refine: ``model.refine`` of the batched greedy 300-s result on its clip
  with ``prob_threshold=0.0`` (random weights give every word a
  probability far below the default 0.5, which ends each span at its
  baseline probe), with ``parallel`` at its default on the card, which
  must run interval rounds in two span groups with several spans a
  round, and with ``parallel=False``; both must launch flash and give the
  same words; on an f32 copy of the weights (seed 0) also the same word
  times (in bf16 a round's batch shape changes the rounding, and the
  differing times are logged); each wall beside the batched greedy's,
  and one round's probabilities batched, alone and sequential;
- dq: the same weights quantized to int8 on the card (``dq=True``), with
  packed int4 cross K/V (``kv_quant=4``): 20 s greedy with language='en',
  20 s beam_size=5 with no language, 60 s batched greedy in a group
  of 2 (the encoder's weight-only products at M = 3000), the 60-s
  ``align_words`` (64 flash, one DTW and the weight-only products at
  M = 8 x 1500), a refine of its result and a locate in mode 1, both of
  which must launch ``woq_matmul``; then the 20-s greedy request again
  with STABLE_TS_TPU_WOQ=dyn (int8 activations x int8 weights through
  ``torch._int_mm``), which must launch ``woq_matmul`` 0 times, its ms a
  step logged beside the default's;
- train: a fresh bf16 model, three steps of ``make_train_step`` (AdamW as
  optax.adamw(1e-5)) at batch 2 windows and 64 tokens, the second with a
  label mask; each step must launch the flash forward and both backward
  kernels 64 times (32 encoder + 32 decoder cross layers) and leave every
  parameter a finite, non-zero gradient; then a fourth step and one
  window's encoder forward under torch.profiler (device busy share);
- mesh one (the multi-GPU layer, ``parallel/``, on a world of one rank
  over NCCL, ``init_process_group`` at world size 1): a fresh large-v3
  bf16 model sharded on its (dp 1, tp 1) mesh runs the batched greedy
  300 s, the 60-s ``align_words`` and a refine of its result (after the
  refine paths), then, after the dq paths, the batched dq request on a
  freshly quantized sharded model and two train steps; each must launch
  its kernels and equal the unsharded run of this process bit for bit
  (collectives over one rank are the identity), its wall logged beside
  the unsharded one's;
- mesh two (last): two ranks spawned on the one card over gloo (NCCL
  refuses two ranks on one GPU; gloo reduces CUDA tensors through the
  host), each on cuda:0, on (dp 1, tp 2) and (dp 2, tp 1):
  ``transcribe_batched`` greedy 60 s at its full sample length,
  ``align_words`` of 20 s and a refine of it on f32 weights, held
  against this process's unsharded f32 runs (the same text and words,
  every start within 0.021 s), the greedy on bf16 weights, 48 tokens a
  window (its differences to the unsharded bf16 run logged),
  and two train steps of large-v3 cut to 4 + 4 layers (f32 losses within
  1e-4 relative); each rank must launch the kernels of each request at
  its shard's shapes, and both ranks return the same results; walls and
  each rank's peak device memory are logged (the ranks share the card,
  so the walls are not a speed-up).

The launch counts are reset before each path (each train step, each
batched and each align request) and read after it; the script fails unless each path
launched the kernels it runs, all thirteen entries among them. Every
kernel is also held against its twin at the batched driver's shapes
(flash over 8 windows, the self and cross entries at 8 rows, the group
entry over 4 windows x 5 beams, the beam entry at 20 rows, int4 at 2 rows,
the epilogue at B = 8, vocab_proj at M = 20, woq_matmul at M = 3000 and
12000, the
DTW over (8, 252, 1500) in one launch beside 8 launches), at the tp = 2
and tp = 4 shard shapes of the mesh paths (flash, the self, cross,
group, beam and int4 entries at 10 and 5 heads, woq_matmul at the
sharded linears' (N, K), M = 8 and 12000), and the
cross entry with bf16 K/V and the self entry with a bf16 cache of 128
rows at pos 25, locate's float caches, at the sequential shapes. The dyn
recipe (a library product, not a kernel of the port, so not in the
kernels line) is held at large-v3's linear shapes, M = 1, 5, 20, 1500 and
3000 over (K, N) = (1280, 5120), (5120, 1280) and (1280, 1280): its int32
sums equal the CPU's bit for bit, its output the CPU's within 1e-6, its
reruns bit-identical, its device time logged beside woq_matmul's and
F.linear's on the weight widened to bf16. A tiny f32
model also takes three train steps on the CPU (twins) and on the card
(kernels), which must agree, and transcribes alike through both (with
known heads, quantized, with no heads, with the 'new' aligner and with
an extra model). The fixed-order kernels (the cross entries on a
thread-block cluster, vocab_proj, bf16 woq_matmul and the bf16 logit
epilogue on wgmma, the self and beam entries with their cache slice in
flight, the DTW) must give bit-identical reruns, and the DTW's costs must equal its twin's bit
for bit. One line gives the device time of an empty launch, the floor
under every decode kernel.

    python3 chip_smoke.py        # needs one CUDA GPU; exits non-zero on any failure

The second-to-last line of stdout is a JSON object with each kernel's
launches on the paths, its error against its twin, its time, its
twin's, the bound on its time (H100 SXM data sheet) and, where one PyTorch
call computes the same function, that call's time (every kernel and
library call by its device time alone, from torch.profiler; the CUDA-event
times, which also read the wrappers' host time, are logged beside them);
the logit epilogue's entry is B = 1's, with B = 5's under "B=5" and
torch.mm of the same product beside each as "yardstick_mm_ms" (not the
same function), and the DTW's has its time a row of the chain
("ms_per_row"); the kernels' numbers at the batched shapes are under "batched" (the
epilogue's B = 8 under "B=8", vocab_proj's M = 20 under "M=20",
woq_matmul's M = 3000 and 12000 under "M=3000" and "M=12000"), the
numbers at the tp shard shapes under "shards"; the cross
entry's bf16 K/V under "bf16_kv", the self entry's bf16 cache at
locate's shape under "bf16_cache" and at (32,1,256,1280) pos 200 under
"bf16_cache_pos200". The line
before it gives the run's
elapsed seconds; the last line is
{"ok": true, "device": {...}}. Without a GPU, or without the package
beside it, the script fails and prints no result.
"""
import copy
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SR = 16000
MODEL = 'large-v3'
HEADS_TINY = [(0, 1), (1, 0), (1, 1)]
# NVIDIA's data sheet for one H100 SXM at 700 W: memory rate (bytes/s) and
# dense peaks (operations/s) by operand type (f32: the CUDA cores; int8:
# the tensor cores' integer rate)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {'bf16': 989e12, 'f32': 67e12, 'int8': 1979e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms (CUDA events around ``iters`` calls)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3, attempts: int = 3) -> float:
    """Mean device time of fn() in ms: the durations of the CUDA kernels
    (and device memsets) it ran, summed by torch.profiler over ``iters``
    calls after warm-up. Unlike cuda_ms, the host's time between launches
    (the wrapper's checks, an autograd graph walk) does not count. A
    profiler session that hands back no kernel at all (seen once, for the
    empty kernel) is repeated, up to ``attempts`` sessions."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and not e.is_user_annotation)
        if us > 0:
            return us / iters / 1e3
    raise AssertionError(f'torch.profiler recorded no device time in {attempts} sessions')


def profiled(fn):
    """fn() once under torch.profiler: (its result, the host-clock wall in s
    with the profiler on, the device busy time in s (the CUDA kernels'
    durations summed), the flash kernels' share of that in s, and the five
    kernels with the most device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # CUDA events but the device-side ranges of record_function annotations
    # (the optimizer step's), which span kernels counted on their own
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    flash = sum(e.self_device_time_total for e in kernels if 'flash_' in e.key) / 1e6
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return out, wall, busy, flash, [(e.key[:48], e.count, round(e.self_device_time_total / 1e3, 3))
                                    for e in top]


def both_ms(fn, iters: int = 20, warmup: int = 3) -> tuple:
    """(device time alone, CUDA-event time) of fn() in ms per call."""
    return device_ms(fn, iters, warmup), cuda_ms(fn, iters, warmup)


def empty_launch_ms(blocks: int = 20, threads: int = 128) -> float:
    """Device time of one launch of the library's empty kernel (a decode
    step's grid: a block per head), the floor under every short kernel."""
    import torch
    from stable_ts_tpu_torch import _build
    lib = _build.lib()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        _build.check(lib.empty_launch(blocks, threads, stream), 'empty_launch')
    return device_ms(launch, iters=200)


def rerun_identical(name: str, fn, got, what: str) -> None:
    """A second call of fn must equal ``got`` bit for bit (fixed-order
    sums, no atomics)."""
    import torch
    again = fn()
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    log(f'[kernel] {name} {what}: rerun bit-identical: {same}')
    if not same:
        raise AssertionError(f'{name} {what}: a rerun differs')


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|), in f32."""
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float, kind: str) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak for their type."""
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / PEAK_OPS_PER_S[kind] * 1e3
    if by_bytes >= by_ops:
        return dict(bound_ms=by_bytes, bound_by='bytes')
    return dict(bound_ms=by_ops, bound_by='operations')


def entry(err, ms, plain, n_bytes, n_ops, kind, library_ms=None) -> dict:
    """One kernel's numbers for the kernels line."""
    return dict(max_abs_err=err, ms=ms, plain_ms=plain,
                **bound(n_bytes, n_ops, kind), library_ms=library_ms)


def check(name: str, got, ref, tol: float, what: str) -> float:
    err, rel = rel_err(got, ref)
    ok = rel <= tol
    log(f'[kernel] {name} {what}: max_abs_err={err:.3e} '
        f'rel_to_max={rel:.3e} (tol {tol:g}) {"OK" if ok else "FAIL"}')
    if not ok:
        raise AssertionError(f'{name} {what}: {rel:.3e} > {tol:g}')
    return err


def kernel_checks(torch, results: dict) -> None:
    """Every kernel against its twin at the large-v3 shapes of the paths
    (bf16 activations, int8 caches) and at one f32 shape."""
    import torch.nn.functional as F
    from stable_ts_tpu_torch.ops import cross_attn, dtw, flash_attn, self_attn
    dev = 'cuda'
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    d, h = 1280, 20
    scale = (d // h) ** -0.5
    # F: encoder self-attention (T = S = 1500) and timing-pass cross-attention
    # (T = 230 tokens against S = 1500 frames), bf16; one f32 shape
    flash = []
    for t, what, dtype, tol in ((1500, 'encoder bf16 (1,1500,1280)', torch.bfloat16, 2e-2),
                                (230, 'cross bf16 (1,230,1280)x1500', torch.bfloat16, 2e-2),
                                (300, 'f32 (1,300,1280)x1500', torch.float32, 1e-4)):
        q, k, v = randn(1, t, d, dtype=dtype), randn(1, 1500, d, dtype=dtype), \
            randn(1, 1500, d, dtype=dtype)
        got = flash_attn.flash_attention(q, k, v, h, scale)
        ref = flash_attn.flash_attention_ref(q, k, v, h, scale)
        torch.cuda.synchronize()
        err = check('flash_attn', got, ref, tol, what)
        qh, kh, vh = (a.view(1, -1, h, d // h).transpose(1, 2) for a in (q, k, v))
        calls = (lambda: flash_attn.flash_attention(q, k, v, h, scale),
                 lambda: flash_attn.flash_attention_ref(q, k, v, h, scale),
                 # the library call: PyTorch's fused attention on the same
                 # tensors viewed as (B, heads, T, d_head)
                 lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale))
        # device time alone (the profiler's kernel durations), and events
        # around the calls (with the host's time, where the host is slower)
        ms, plain, lib = (device_ms(fn) for fn in calls)
        ev, ev_plain, ev_lib = (cuda_ms(fn) for fn in calls)
        # q, k and v read once, the output (q's shape) written once
        numbers = entry(err, ms, plain, nbytes(q, k, v, q), 4 * t * 1500 * d,
                        'bf16' if dtype == torch.bfloat16 else 'f32', lib)
        log(f'[kernel] flash_attn {what}: device kernel {ms:.4f} ms, twin {plain:.4f} ms, '
            f'scaled_dot_product_attention {lib:.4f} ms; events {ev:.4f}, {ev_plain:.4f}, '
            f'{ev_lib:.4f} ms; bound {numbers["bound_ms"]:.4f} ms ({numbers["bound_by"]})')
        flash.append(numbers)
    results['flash_attn'] = flash[0]

    # D, self entry: one layer of the (32, 1, 256, 1280) int8 row cache, pos
    # 200; bf16 and f32 caches beside it with PyTorch's fused attention on
    # the same keys (for the f32 cache the same function; for bf16 the query
    # is rounded to bf16 first, so a yardstick); and locate's bf16 cache of
    # confirm_cache_len = 128 rows at pos 25, where most of the kernel's
    # key-splitting warps hold few keys or none
    layers, bf16_self = 32, {}
    for what, cdtype, ctx, pos in (
            ('int8 cache (32,1,256,1280) pos 200', torch.int8, 256, 200),
            ('bf16 cache (32,1,256,1280) pos 200', torch.bfloat16, 256, 200),
            ('f32 cache (32,1,256,1280) pos 200', torch.float32, 256, 200),
            ('bf16 cache (32,1,128,1280) pos 25', torch.bfloat16, 128, 25)):
        raw = randn(layers, 1, ctx, d)
        raw_v = randn(layers, 1, ctx, d)
        if cdtype == torch.int8:
            from stable_ts_tpu_torch.models.whisper.model import quantize_rows
            kc, ks = quantize_rows(raw)
            vc, vs = quantize_rows(raw_v)
        else:
            kc, vc, ks, vs = raw.to(cdtype), raw_v.to(cdtype), None, None
        q = randn(1, d) * scale
        lay = 5
        args = (q, kc[lay], vc[lay], None if ks is None else ks[lay],
                None if vs is None else vs[lay], pos, h)
        got = self_attn.self_attn_decode(*args)
        ref = self_attn.self_attn_decode_ref(*args)
        torch.cuda.synchronize()
        err = check('self_attn_decode', got, ref, 1e-4, what)
        rerun_identical('self_attn_decode', lambda: self_attn.self_attn_decode(*args), got,
                        what)
        ms, ev = both_ms(lambda: self_attn.self_attn_decode(*args), iters=200)
        plain = device_ms(lambda: self_attn.self_attn_decode_ref(*args), iters=200)
        extra = ''
        if cdtype != torch.int8:
            n = pos + 1
            qh = q.to(cdtype).view(1, 1, h, d // h).transpose(1, 2)
            kh, vh = (c[lay, :, :n].view(1, n, h, d // h).transpose(1, 2) for c in (kc, vc))
            lib = device_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=1.0),
                            iters=200)
            label = ('scaled_dot_product_attention' if cdtype == torch.float32
                     else 'scaled_dot_product_attention on a bf16 query (yardstick)')
            extra = f', {label} {lib:.4f} ms'
        log(f'[kernel] self_attn_decode {what}: device kernel {ms:.4f} ms, twin '
            f'{plain:.4f} ms{extra}; events {ev:.4f} ms')
        # keys 0..pos of one layer's K and V rows (and their scales)
        n = pos + 1
        if cdtype == torch.int8:
            results['self_attn_decode'] = entry(
                err, ms, plain, 2 * n * (d + 4) + nbytes(q, got), 4 * n * d, 'f32')
        elif cdtype == torch.bfloat16:
            # a bf16 cache; at 128 rows, pos 25 the float cache of locate's
            # confirmation decode (SDPA on a bf16 query is a yardstick, not
            # the same function)
            bf16_self[ctx] = entry(err, ms, plain, 2 * n * d * 2 + nbytes(q, got),
                                   4 * n * d, 'f32')
    results['self_attn_decode']['bf16_cache'] = bf16_self[128]
    results['self_attn_decode']['bf16_cache_pos200'] = bf16_self[256]

    # D, cross entry: int8 K/V (32, 1, 2, 1500, 1280), s = 1500; f32, and
    # bf16 (the float K/V of locate's confirmation decode)
    for what, kind in (('int8 kv (32,1,2,1500,1280)', 'int8'),
                       ('f32 kv (32,1,2,1500,1280)', 'f32'),
                       ('bf16 kv (32,1,2,1500,1280)', 'bf16')):
        kv = randn(layers, 1, 2, 1500, d)
        sc = torch.ones((layers, 1, 2, 1500), device=dev)
        if kind == 'int8':
            from stable_ts_tpu_torch.models.whisper.model import quantize_rows
            kv, sc = quantize_rows(kv)
        elif kind == 'bf16':
            kv = kv.to(torch.bfloat16)
        q = randn(1, d) * scale
        got = cross_attn.cross_attn_decode(q, kv, sc, 7, 1500, h)
        ref = cross_attn.cross_attn_decode_ref(q, kv[7, :, 0], kv[7, :, 1],
                                               sc[7, :, 0], sc[7, :, 1], 1500, h)
        torch.cuda.synchronize()
        # both round q and the weights to bf16 at the same places; a weight
        # whose f32 value differs in its last bit may round the other way
        err = check('cross_attn_decode', got, ref, 1e-3, what)
        rerun_identical('cross_attn_decode',
                        lambda: cross_attn.cross_attn_decode(q, kv, sc, 7, 1500, h), got, what)
        ms, ev = both_ms(lambda: cross_attn.cross_attn_decode(q, kv, sc, 7, 1500, h),
                         iters=200)
        plain = device_ms(lambda: cross_attn.cross_attn_decode_ref(
            q, kv[7, :, 0], kv[7, :, 1], sc[7, :, 0], sc[7, :, 1], 1500, h),
            iters=200)
        log(f'[kernel] cross_attn_decode {what}: device kernel {ms:.4f} ms, twin '
            f'{plain:.4f} ms; events {ev:.4f} ms')
        if kind == 'int8':
            results['cross_attn_decode'] = entry(
                err, ms, plain, nbytes(kv[7], sc[7], q, got), 4 * 1500 * d, 'bf16')
        elif kind == 'bf16':
            bf16_cross = entry(err, ms, plain, nbytes(kv[7], sc[7], q, got),
                               4 * 1500 * d, 'bf16')
    results['cross_attn_decode']['bf16_kv'] = bf16_cross

    # W: a (1, 226, 1500) attention-like cost (negated, median-filtered
    # z-scores of a softmax), the largest the timing pass hands it
    from stable_ts_tpu_torch.models.whisper.timing import legacy_head_weights
    qk = (randn(3, 230, 1500) * 4).to(torch.bfloat16)
    mat = legacy_head_weights(qk, 1500, 3, 1.0, 7).mean(0)
    x = -mat[None].float().contiguous()
    got = dtw.dtw_cost(x)
    ref = dtw.dtw_cost_ref(x)
    torch.cuda.synchronize()
    # the kernel and the twin round the same f64 prefix sums once and take
    # exact minima: the costs must be equal bit for bit
    same = torch.equal(got, ref)
    err = (got - ref).abs().max().item()
    log(f'[kernel] dtw_cost cost (1,226,1500) f32: equal to the twin bit for bit: {same} '
        f'(max_abs_err={err:.3e})')
    if not same:
        raise AssertionError('dtw_cost: the costs differ from the twin\'s')
    rerun_identical('dtw_cost', lambda: dtw.dtw_cost(x), got, '(1,226,1500)')
    n, m = mat.shape
    jk = dtw.dtw_jumps(got[0].cpu().numpy(), n, m)
    jr = dtw.dtw_jumps(ref[0].cpu().numpy(), n, m)
    same = bool((jk == jr).all())
    log(f'[kernel] dtw_cost jump frames identical to the twin\'s: {same} '
        f'({n} tokens, {m} frames)')
    if not same:
        raise AssertionError('DTW jump frames differ between kernel and twin')
    ms, ev = both_ms(lambda: dtw.dtw_cost(x))
    plain = device_ms(lambda: dtw.dtw_cost_ref(x), iters=3, warmup=1)
    log(f'[kernel] dtw_cost (1,226,1500): device kernel {ms:.4f} ms ({ms / n * 1e3:.3f} us '
        f'a row over the {n}-row chain), twin {plain:.4f} ms; events {ev:.4f} ms')
    # an add and two minimums per cell
    results['dtw_cost'] = entry(err, ms, plain, nbytes(x, got), 3 * n * m, 'f32')
    results['dtw_cost']['ms_per_row'] = ms / n

    # D, cross group entry: g = 5 query rows on one window's int8 K/V
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    g = 5
    kv, sc = quantize_rows(randn(layers, 1, 2, 1500, d))
    q = randn(g, d) * scale
    args = (q, kv, sc, 7, 1500, h)
    ref_args = (q, kv[7, :, 0], kv[7, :, 1], sc[7, :, 0], sc[7, :, 1], 1500, h, g)
    got = cross_attn.cross_attn_decode(*args, q_per_kv=g)
    ref = cross_attn.cross_attn_decode_ref(*ref_args)
    torch.cuda.synchronize()
    what = 'g=5 int8 kv (32,1,2,1500,1280)'
    err = check('cross_attn_decode_group', got, ref, 1e-3, what)
    rerun_identical('cross_attn_decode_group',
                    lambda: cross_attn.cross_attn_decode(*args, q_per_kv=g), got, what)
    ms, ev = both_ms(lambda: cross_attn.cross_attn_decode(*args, q_per_kv=g), iters=200)
    plain = device_ms(lambda: cross_attn.cross_attn_decode_ref(*ref_args), iters=200)
    log(f'[kernel] cross_attn_decode_group {what}: device kernel {ms:.4f} ms, twin '
        f'{plain:.4f} ms; events {ev:.4f} ms')
    results['cross_attn_decode_group'] = entry(
        err, ms, plain, nbytes(kv[7], sc[7], q, got), 4 * g * 1500 * d, 'bf16')

    # D, beam self entry: int8 cache (32, 5, 256, 1280), pos 200, a random
    # valid ancestry table (each row's own index at pos)
    rows = 5
    kc, ks = quantize_rows(randn(layers, rows, ctx, d))
    vc, vs = quantize_rows(randn(layers, rows, ctx, d))
    anc = torch.randint(0, rows, (rows, ctx), generator=gen, device=dev,
                        dtype=torch.int32)
    anc[:, pos] = torch.arange(rows, device=dev, dtype=torch.int32)
    q = randn(rows, d) * scale
    args = (q, kc[5], vc[5], ks[5], vs[5], pos, h)
    got = self_attn.self_attn_decode(*args, anc=anc, q_per_kv=rows)
    ref = self_attn.self_attn_decode_ref(*args, anc=anc, q_per_kv=rows)
    torch.cuda.synchronize()
    what = 'int8 cache (32,5,256,1280) pos 200, random anc'
    err = check('self_attn_decode_beam', got, ref, 1e-4, what)
    rerun_identical('self_attn_decode_beam',
                    lambda: self_attn.self_attn_decode(*args, anc=anc, q_per_kv=rows), got,
                    what)
    ms, ev = both_ms(lambda: self_attn.self_attn_decode(*args, anc=anc, q_per_kv=rows),
                     iters=200)
    plain = device_ms(lambda: self_attn.self_attn_decode_ref(*args, anc=anc,
                                                             q_per_kv=rows), iters=200)
    log(f'[kernel] self_attn_decode_beam {what}: device kernel {ms:.4f} ms, twin '
        f'{plain:.4f} ms; events {ev:.4f} ms')
    # the cache rows this ancestry table reaches (each once), their scales,
    # the table's keys 0..pos, q and the output
    n = pos + 1
    reached = sum(len(set(anc[:, j].tolist())) for j in range(n))
    results['self_attn_decode_beam'] = entry(
        err, ms, plain, 2 * reached * (d + 4) + nbytes(anc[:, :n], q, got),
        4 * rows * n * d, 'f32')

    floor = empty_launch_ms()
    log(f'[kernel] empty launch (libkernels.so empty_launch, 20 blocks of 128 threads): '
        f'device {floor:.4f} ms, the floor under every decode kernel')

    epilogue_checks(torch, results, randn, gen)
    int4_cross_checks(torch, results, randn)
    woq_checks(torch, results, randn)
    vocab_checks(torch, results, randn)
    flash_bwd_checks(torch, results, randn)
    batched_kernel_checks(torch, results, randn, gen)
    shard_kernel_checks(torch, results, randn, gen)


def step_graph_checks(torch, model, results: dict) -> None:
    """The greedy step's CUDA graph path (models/whisper/step_graph.py) at
    the main path's shapes: the self entry given its position as a 0-d
    int64 on the device (32 rows, cache 256, d 1280, int8, pos 200) and the
    g = 1 cross entry given its K/V and scale buffers' addresses on the
    device (32 rows, 1500 keys, int8), each held against its twin and bit
    for bit against the entry given the int or the buffers; then a 32-row
    greedy group of the model whose steps replay a captured graph, under
    torch.profiler: each replay must run those two kernel instantiations
    once a layer (and the int and direct ones never), and the group's
    tokens and summed log-probabilities must equal the eager loop's."""
    import re
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from stable_ts_tpu_torch import profiling
    from stable_ts_tpu_torch.models.whisper import decoding, step_graph
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops import cross_attn, self_attn
    gen = torch.Generator(device='cuda').manual_seed(18)
    rows, d, h, lay = 32, 1280, 20, 1
    scale = (d // h) ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda')

    # the self entry: layer 1 of a (2, 32, 256, 1280) int8 cache, so the
    # strides are the decode's
    (kc, ks), (vc, vs) = quantize_rows(randn(2, rows, 256, d)), quantize_rows(
        randn(2, rows, 256, d))
    q = randn(rows, d) * scale
    what = 'int8 cache (32 rows, 256, 1280), pos 200 on the device'
    args = (q, kc[lay], vc[lay], ks[lay], vs[lay])
    pos = torch.tensor(200, device='cuda')
    got = self_attn.self_attn_decode(*args, pos, h)
    want = self_attn.self_attn_decode(*args, 200, h)
    ref = self_attn.self_attn_decode_ref(*args, 200, h)
    torch.cuda.synchronize()
    err = check('self_attn_decode', got, ref, 1e-4, what)
    if not torch.equal(got, want):
        raise AssertionError(f'self_attn_decode {what}: differs from the int position')
    ms = device_ms(lambda: self_attn.self_attn_decode(*args, pos, h), iters=200)
    ms_int = device_ms(lambda: self_attn.self_attn_decode(*args, 200, h), iters=200)
    log(f'[kernel] self_attn_decode {what}: bit-identical to the int position; '
        f'device kernel {ms:.4f} ms, the int position {ms_int:.4f} ms')
    results['self_attn_decode']['device_pos'] = entry(
        err, ms, None, 2 * 201 * (d + 4) * rows + nbytes(q, got), 4 * 201 * d * rows, 'f32')

    # the cross entry: layer 1 of (2, 32, 2, 1500, 1280) int8 K/V, read
    # through addresses on the device; the layout tensors hold other values
    kv, sc = quantize_rows(randn(2, rows, 2, 1500, d))
    layout_kv, layout_sc = quantize_rows(randn(2, rows, 2, 1500, d))
    bases = torch.tensor([kv.data_ptr(), sc.data_ptr()], device='cuda')
    q = randn(rows, d) * scale
    what = 'int8 kv (32 rows, 1500, 1280), buffers read on the device'
    got = cross_attn.cross_attn_decode_indirect(q, layout_kv, layout_sc, bases, lay, 1500, h)
    want = cross_attn.cross_attn_decode(q, kv, sc, lay, 1500, h)
    ref = cross_attn.cross_attn_decode_ref(q, kv[lay, :, 0], kv[lay, :, 1], sc[lay, :, 0],
                                           sc[lay, :, 1], 1500, h)
    torch.cuda.synchronize()
    err = check('cross_attn_decode', got, ref, 1e-3, what)
    if not torch.equal(got, want):
        raise AssertionError(f'cross_attn_decode {what}: differs from the direct entry')
    ms = device_ms(lambda: cross_attn.cross_attn_decode_indirect(
        q, layout_kv, layout_sc, bases, lay, 1500, h), iters=200)
    ms_direct = device_ms(lambda: cross_attn.cross_attn_decode(q, kv, sc, lay, 1500, h),
                          iters=200)
    log(f'[kernel] cross_attn_decode {what}: bit-identical to the direct entry; '
        f'device kernel {ms:.4f} ms, direct {ms_direct:.4f} ms')
    results['cross_attn_decode']['bases'] = entry(
        err, ms, None, nbytes(kv[lay], sc[lay], q, got), 4 * 1500 * d * rows, 'bf16')
    del kc, vc, ks, vs, kv, sc, layout_kv, layout_sc

    # a 32-row greedy group: captured in a first decode, replayed in a
    # second under the profiler, then the same group eagerly
    dims = model.dims
    feats = randn(rows, 1500, dims.n_audio_state).to(torch.bfloat16)
    options = decoding.DecodingOptions(language='en', temperature=0.0, sample_len=100)
    model.params.decoder._step_graph = None
    model.decode_launch(feats, options)
    torch.cuda.synchronize()
    with profiling.recording() as rec, profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        graphed = model.decode_launch(feats, options).outputs
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    replays = rec.counters.get('decode.graph_replays', 0)
    eager_steps = rec.counters.get('decode.eager_steps', 0)
    seen = {}
    for e in prof.key_averages():
        m = re.search(r'(decode_attn_kernel|cross_cluster_kernel)<([^>]*)>', e.key)
        if e.device_type == DeviceType.CUDA and m:
            key = f'{m.group(1)}<{m.group(2)}>'
            seen[key] = seen.get(key, 0) + e.count
    log(f'[step graph] replayed group: {replays} replays, {eager_steps} eager steps, '
        f'{rec.counters.get("decode.graph_captures", 0)} captures; decode kernels seen '
        f'by the profiler: {seen}')
    layers = dims.n_text_layer
    want_seen = {'decode_attn_kernel<signed char, 64, false, true>': layers * replays,
                 'cross_cluster_kernel<signed char, 64, true>': layers * replays}
    if replays != graphed[0].shape[1] - 1 or not replays or eager_steps or seen != want_seen:
        raise AssertionError(f'step graph: a replayed group ran {seen} in {replays} '
                             f'replays and {eager_steps} eager steps, not {want_seen}')
    real = step_graph.graphable
    step_graph.graphable = lambda *a, **k: False
    try:
        t0 = time.perf_counter()
        eager = model.decode_launch(feats, options).outputs
        torch.cuda.synchronize()
        eager_wall = time.perf_counter() - t0
    finally:
        step_graph.graphable = real
    same = all(torch.equal(a, b) for a, b in zip(graphed, eager))
    log(f'[step graph] 32-row greedy group, {graphed[0].shape[1]} tokens: graphed '
        f'{wall:.3f} s (under the profiler), eager {eager_wall:.3f} s; tokens and '
        f'summed log-probabilities bit-identical: {same}')
    if not same:
        raise AssertionError('step graph: the replayed group differs from the eager one')


def batched_kernel_checks(torch, results: dict, randn, gen) -> None:
    """The kernels at the shapes the batched driver sends them (large-v3,
    groups of 8 windows): flash over 8 windows (encoder (8,1500,1280) and
    the capture pass (8,256,1280) x 1500); the self and cross entries at 8
    rows; the cross group entry over 4 windows x 5 beams and the beam self
    entry at 20 rows; the int4 cross entry at 2 rows; the DTW over (8,252,
    1500) in one launch, beside 8 launches of one window each (the
    yardstick). Each within its twin's tolerance as at the sequential
    shapes, reruns bit-identical where the kernel sums in a fixed order,
    with its device time, its twin's, its bound and, for flash, SDPA's;
    the numbers go under "batched" in each kernel's entry."""
    import torch.nn.functional as F
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.models.whisper.timing import legacy_weights_batched
    from stable_ts_tpu_torch.ops import cross_attn, dtw, flash_attn, self_attn
    d, h, s, ctx, pos = 1280, 20, 1500, 256, 200
    scale = (d // h) ** -0.5

    def put(name, key, numbers):
        results[name].setdefault('batched', {})[key] = numbers

    for b, t, what in ((8, 1500, 'encoder bf16 (8,1500,1280)'),
                       (8, 256, 'capture pass bf16 (8,256,1280)x1500')):
        q = randn(b, t, d, dtype=torch.bfloat16)
        k, v = randn(b, s, d, dtype=torch.bfloat16), randn(b, s, d, dtype=torch.bfloat16)
        got = flash_attn.flash_attention(q, k, v, h, scale)
        ref = flash_attn.flash_attention_ref(q, k, v, h, scale)
        torch.cuda.synchronize()
        err = check('flash_attn', got, ref, 2e-2, what)
        qh, kh, vh = (a.view(b, -1, h, d // h).transpose(1, 2) for a in (q, k, v))
        ms, plain, lib = (device_ms(fn, iters=10) for fn in (
            lambda: flash_attn.flash_attention(q, k, v, h, scale),
            lambda: flash_attn.flash_attention_ref(q, k, v, h, scale),
            lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)))
        numbers = entry(err, ms, plain, nbytes(q, k, v, q), 4 * b * t * s * d, 'bf16', lib)
        log(f'[kernel] flash_attn {what}: device kernel {ms:.4f} ms, twin {plain:.4f} ms, '
            f'scaled_dot_product_attention {lib:.4f} ms; bound {numbers["bound_ms"]:.4f} ms '
            f'({numbers["bound_by"]})')
        put('flash_attn', what, numbers)
        del q, k, v, got, ref

    # the self entry at 8 rows: one layer of an (8, 256, 1280) int8 cache
    rows = 8
    kc, ks = quantize_rows(randn(rows, ctx, d))
    vc, vs = quantize_rows(randn(rows, ctx, d))
    q = randn(rows, d) * scale
    args = (q, kc, vc, ks, vs, pos, h)
    what = 'int8 cache (8,256,1280) pos 200, 8 rows'
    got = self_attn.self_attn_decode(*args)
    ref = self_attn.self_attn_decode_ref(*args)
    torch.cuda.synchronize()
    err = check('self_attn_decode', got, ref, 1e-4, what)
    rerun_identical('self_attn_decode', lambda: self_attn.self_attn_decode(*args), got, what)
    ms = device_ms(lambda: self_attn.self_attn_decode(*args), iters=200)
    plain = device_ms(lambda: self_attn.self_attn_decode_ref(*args), iters=200)
    n = pos + 1
    numbers = entry(err, ms, plain, 2 * rows * n * (d + 4) + nbytes(q, got),
                    4 * rows * n * d, 'f32')
    log(f'[kernel] self_attn_decode {what}: device kernel {ms:.4f} ms, twin {plain:.4f} ms, '
        f'bound {numbers["bound_ms"]:.5f} ms')
    put('self_attn_decode', '8 rows', numbers)

    # the cross entries on 8 windows' int8 K/V (8 layers of (8, 2, 1500, 1280))
    layers = 8
    for windows, g, name, what in (
            (8, 1, 'cross_attn_decode', 'int8 kv (8,8,2,1500,1280), 8 rows'),
            (4, 5, 'cross_attn_decode_group', 'g=5 int8 kv (8,4,2,1500,1280), 20 rows')):
        kv, sc = quantize_rows(randn(layers, windows, 2, s, d))
        q = randn(windows * g, d) * scale
        args = (q, kv, sc, 7, s, h)
        ref_args = (q, kv[7, :, 0], kv[7, :, 1], sc[7, :, 0], sc[7, :, 1], s, h, g)
        got = cross_attn.cross_attn_decode(*args, q_per_kv=g)
        ref = cross_attn.cross_attn_decode_ref(*ref_args)
        torch.cuda.synchronize()
        err = check(name, got, ref, 1e-3, what)
        rerun_identical(name, lambda: cross_attn.cross_attn_decode(*args, q_per_kv=g), got, what)
        ms = device_ms(lambda: cross_attn.cross_attn_decode(*args, q_per_kv=g), iters=200)
        plain = device_ms(lambda: cross_attn.cross_attn_decode_ref(*ref_args), iters=50)
        numbers = entry(err, ms, plain, nbytes(kv[7], sc[7], q, got), 4 * windows * g * s * d,
                        'bf16')
        log(f'[kernel] {name} {what}: device kernel {ms:.4f} ms, twin {plain:.4f} ms, bound '
            f'{numbers["bound_ms"]:.5f} ms')
        put(name, f'{windows * g} rows', numbers)
        del kv, sc

    # the beam self entry at 20 rows (4 windows x 5 beams), a random valid
    # ancestry table (each row's own local index at pos)
    rows, g = 20, 5
    kc, ks = quantize_rows(randn(rows, ctx, d))
    vc, vs = quantize_rows(randn(rows, ctx, d))
    anc = torch.randint(0, g, (rows, ctx), generator=gen, device='cuda', dtype=torch.int32)
    anc[:, pos] = torch.arange(rows, device='cuda', dtype=torch.int32) % g
    q = randn(rows, d) * scale
    args = (q, kc, vc, ks, vs, pos, h)
    what = 'int8 cache (20,256,1280) pos 200, 4 windows x 5 beams, random anc'
    got = self_attn.self_attn_decode(*args, anc=anc, q_per_kv=g)
    ref = self_attn.self_attn_decode_ref(*args, anc=anc, q_per_kv=g)
    torch.cuda.synchronize()
    err = check('self_attn_decode_beam', got, ref, 1e-4, what)
    rerun_identical('self_attn_decode_beam',
                    lambda: self_attn.self_attn_decode(*args, anc=anc, q_per_kv=g), got, what)
    ms = device_ms(lambda: self_attn.self_attn_decode(*args, anc=anc, q_per_kv=g), iters=200)
    plain = device_ms(lambda: self_attn.self_attn_decode_ref(*args, anc=anc, q_per_kv=g),
                      iters=50)
    n = pos + 1
    reached = sum(len(set((anc[w * g:(w + 1) * g, j] + w * g).tolist()))
                  for w in range(rows // g) for j in range(n))
    numbers = entry(err, ms, plain, 2 * reached * (d + 4) + nbytes(anc[:, :n], q, got),
                    4 * rows * n * d, 'f32')
    log(f'[kernel] self_attn_decode_beam {what}: device kernel {ms:.4f} ms, twin '
        f'{plain:.4f} ms, bound {numbers["bound_ms"]:.5f} ms')
    put('self_attn_decode_beam', '20 rows', numbers)

    # the int4 cross entry at 2 rows (the batched dq request's group of 2)
    vals, sc = quantize_rows(randn(layers, 2, 2, s, d), bits=4)
    kv = cross_attn.pack_int4(vals)
    q = randn(2, d) * scale
    args = (q, kv, sc, 7, s, h)
    ref_args = (q, vals[7, :, 0], vals[7, :, 1], sc[7, :, 0], sc[7, :, 1], s, h, 1)
    what = 'int4 kv (8,2,2,1500,1280) packed, 2 rows'
    got = cross_attn.cross_attn_decode(*args, bits=4)
    ref = cross_attn.cross_attn_decode_ref(*ref_args)
    torch.cuda.synchronize()
    err = check('cross_attn_decode_int4', got, ref, 1e-3, what)
    rerun_identical('cross_attn_decode_int4',
                    lambda: cross_attn.cross_attn_decode(*args, bits=4), got, what)
    ms = device_ms(lambda: cross_attn.cross_attn_decode(*args, bits=4), iters=200)
    plain = device_ms(lambda: cross_attn.cross_attn_decode_ref(*ref_args), iters=50)
    numbers = entry(err, ms, plain, nbytes(kv[7], sc[7], q, got), 4 * 2 * s * d, 'bf16')
    log(f'[kernel] cross_attn_decode_int4 {what}: device kernel {ms:.4f} ms, twin '
        f'{plain:.4f} ms, bound {numbers["bound_ms"]:.5f} ms')
    put('cross_attn_decode_int4', '2 rows', numbers)

    # the DTW over a group: 8 windows of 252 token rows x 1500 frames in one
    # launch (the batched legacy weights of a random capture), bit for bit
    # its twin's, beside 8 launches of one window each
    qk = (randn(3, 8, 256, s) * 4).to(torch.bfloat16)
    full = torch.full((8,), s, device='cuda')
    mats = legacy_weights_batched(qk, full, torch.full((8,), 252, device='cuda'), 3, 1.0, 7)
    x = -mats.contiguous()
    got = dtw.dtw_cost(x)
    ref = dtw.dtw_cost_ref(x)
    torch.cuda.synchronize()
    same = torch.equal(got, ref)
    err = (got - ref).abs().max().item()
    what = '(8,252,1500) f32, one launch'
    log(f'[kernel] dtw_cost cost {what}: equal to the twin bit for bit: {same} '
        f'(max_abs_err={err:.3e})')
    if not same:
        raise AssertionError('dtw_cost: the batched costs differ from the twin\'s')
    rerun_identical('dtw_cost', lambda: dtw.dtw_cost(x), got, what)
    singles = [x[i:i + 1].contiguous() for i in range(8)]
    ms = device_ms(lambda: dtw.dtw_cost(x))
    eight = device_ms(lambda: [dtw.dtw_cost(one) for one in singles])
    plain = device_ms(lambda: dtw.dtw_cost_ref(x), iters=3, warmup=1)
    numbers = entry(err, ms, plain, nbytes(x, got), 3 * 8 * 252 * s, 'f32')
    numbers['yardstick_8_launches_ms'] = eight
    log(f'[kernel] dtw_cost {what}: device kernel {ms:.4f} ms, 8 launches of one window '
        f'{eight:.4f} ms (yardstick), twin {plain:.4f} ms, bound {numbers["bound_ms"]:.5f} ms')
    put('dtw_cost', '(8,252,1500)', numbers)


def epilogue_checks(torch, results: dict, randn, gen) -> None:
    """The logit epilogue at large-v3 shapes (emb (51866, 1280) bf16) for
    B = 1, 5 and 8 (the batched driver's greedy step; the 8-row
    template), with a suppress list, a silence mask and grammar flags that
    differ across rows. Aggregates within 1e-3 relative; argmax ids equal
    wherever the top two filtered logits of a part differ by more than
    that."""
    from stable_ts_tpu_torch.ops import logit_epilogue as epi
    v, d, ts_begin, eot = 51866, 1280, 50365, 50257
    emb = (randn(v, d) * 0.02).to(torch.bfloat16)
    suppress = torch.where(torch.rand(v, generator=gen, device='cuda') < 0.02,
                           -1e9, 0.0)
    for b in (1, 5, 8):
        x = randn(b, d).to(torch.bfloat16)
        sil = torch.zeros((b, v), device='cuda')
        sil[:, ts_begin:] = torch.where(
            torch.rand((b, v - ts_begin), generator=gen, device='cuda') < 0.3,
            -1e9, 0.0)
        r = torch.arange(b, device='cuda')
        flags = torch.stack([(r % 3 == 1).long(), (r % 3 == 2).long(),
                             (r % 2 == 0).long(), (r * 211) % 700], 1).int()
        args = (x, emb, suppress, sil, flags, ts_begin, eot, True)
        got = epi.fused_logit_aggregates(*args)
        ref = epi.fused_logit_aggregates_ref(*args)
        torch.cuda.synchronize()
        what = f'B={b} emb (51866,1280) bf16, silence mask, varied flags'
        cols = [0, 2, 3, 5]
        err = (got[:, cols] - ref[:, cols]).abs().max().item()
        rel = ((got[:, cols] - ref[:, cols]).abs()
               / ref[:, cols].abs().clamp_min(1.0)).max().item()
        filtered = epi.grammar_filter(
            x.float() @ emb.float().t(), suppress, sil, flags, ts_begin, eot)
        ids_ok = True
        for part, (lo, hi) in enumerate(((0, ts_begin), (ts_begin, v))):
            top2 = filtered[:, lo:hi].topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 1e-3 * top2[:, 0].abs().clamp_min(1.0)
            col = 1 + 3 * part
            ids_ok &= bool((got[clear, col] == ref[clear, col]).all())
        ok = rel <= 1e-3 and ids_ok
        log(f'[kernel] logit_epilogue {what}: max_abs_err={err:.3e} '
            f'rel={rel:.3e} (tol 1e-3), argmax ids equal where the top two '
            f'differ: {ids_ok} {"OK" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'logit_epilogue {what} disagrees with its twin')
        rerun_identical('logit_epilogue', lambda: epi.fused_logit_aggregates(*args), got,
                        what)
        ms, ev = both_ms(lambda: epi.fused_logit_aggregates(*args), iters=50)
        plain = device_ms(lambda: epi.fused_logit_aggregates_ref(*args), iters=20)
        # the yardstick: the product alone, as one library call (no filters,
        # no fold; not the same function, so not library_ms)
        mm = device_ms(lambda: torch.mm(x, emb.t(), out_dtype=torch.float32), iters=50)
        log(f'[kernel] logit_epilogue {what}: device kernel {ms:.4f} ms, twin '
            f'{plain:.4f} ms, yardstick torch.mm(x, emb.t(), out_dtype=f32) {mm:.4f} ms; '
            f'events {ev:.4f} ms')
        numbers = entry(err, ms, plain, nbytes(x, emb, suppress, sil, flags, got),
                        2 * b * v * d, 'bf16')
        numbers['yardstick_mm_ms'] = mm
        if b == 1:
            results['logit_epilogue'] = numbers
        else:
            results['logit_epilogue'][f'B={b}'] = numbers


def int4_cross_checks(torch, results: dict, randn) -> None:
    """The packed int4 cross entries (g = 1 and g = 5) on one window's
    (32, 1, 2, 1500, 1280) K/V on the int4 grid, against the twin fed the
    unpacked values."""
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops import cross_attn
    layers, d, h, s = 32, 1280, 20, 1500
    vals, sc = quantize_rows(randn(layers, 1, 2, s, d), bits=4)
    kv = cross_attn.pack_int4(vals)
    for g, name in ((1, 'cross_attn_decode_int4'), (5, 'cross_attn_decode_group_int4')):
        q = randn(g, d) * (d // h) ** -0.5
        args = (q, kv, sc, 7, s, h)
        ref_args = (q, vals[7, :, 0], vals[7, :, 1], sc[7, :, 0], sc[7, :, 1], s, h, g)
        got = cross_attn.cross_attn_decode(*args, q_per_kv=g, bits=4)
        ref = cross_attn.cross_attn_decode_ref(*ref_args)
        torch.cuda.synchronize()
        what = f'g={g} int4 kv (32,1,2,1500,1280) packed (32,1,2,1500,640)'
        err = check(name, got, ref, 1e-3, what)
        rerun_identical(name, lambda: cross_attn.cross_attn_decode(
            *args, q_per_kv=g, bits=4), got, what)
        ms, ev = both_ms(lambda: cross_attn.cross_attn_decode(*args, q_per_kv=g, bits=4),
                         iters=200)
        plain = device_ms(lambda: cross_attn.cross_attn_decode_ref(*ref_args), iters=200)
        log(f'[kernel] {name} {what}: device kernel {ms:.4f} ms, twin {plain:.4f} ms; '
            f'events {ev:.4f} ms')
        results[name] = entry(err, ms, plain, nbytes(kv[7], sc[7], q, got),
                              4 * g * s * d, 'bf16')


def woq_checks(torch, results: dict, randn) -> None:
    """The weight-only int8 matmul at the dq paths' shapes: M = 1 and 5
    (decode), 230 (the timing pass), 1500 (the encoder) for each (K, N) of
    the decoder's fused qkv, out, fc1 and fc2 linears, bf16 x (the
    tensor-core kernel), and M = 3000 at (1280, 5120) (the batched dq
    encoder's two windows); one f32 x (CUDA cores). The kernel's f32 output
    (before the wrapper's cast) against the twin's within 1e-5 of its
    largest value: the same exact products summed in another order; bf16
    reruns bit-identical. Beside each bf16 shape, as yardsticks (not the
    same function): F.linear on the weight pre-widened to bf16 (no scales,
    bf16 output) and torch._weight_int8pack_mm (bf16 scales and output)."""
    import torch.nn.functional as F
    from stable_ts_tpu_torch.models.whisper.quantization import quantize_weight
    from stable_ts_tpu_torch.ops import woq_matmul as woq
    shapes = [(m, k, n, torch.bfloat16, 1e-5) for m in (1, 5, 230, 1500)
              for k, n in ((1280, 3840), (1280, 1280), (1280, 5120), (5120, 1280))]
    # the batched dq encoder: two windows' 1500 frames a product; the dq
    # align_words: eight rows of 1500 frames
    shapes.append((3000, 1280, 5120, torch.bfloat16, 1e-5))
    shapes.append((12000, 1280, 5120, torch.bfloat16, 1e-5))
    shapes.append((230, 1280, 5120, torch.float32, 1e-5))
    weights = {}
    for m, k, n, dtype, tol in shapes:
        if (k, n) not in weights:
            weights[k, n] = quantize_weight(randn(n, k) * 0.02)
        q, scale = weights[k, n]
        x = randn(m, k, dtype=dtype)
        got = woq._woq_cuda(x, q, scale)
        ref = woq.woq_matmul_ref(x, q, scale)
        torch.cuda.synchronize()
        what = f'M={m} (K,N)=({k},{n}) {str(dtype)[6:]} x'
        err = check('woq_matmul', got, ref, tol, what)
        iters = 200 if m <= 5 else 20
        ms, ev = both_ms(lambda: woq._woq_cuda(x, q, scale), iters=iters)
        plain = device_ms(lambda: woq.woq_matmul_ref(x, q, scale), iters=iters)
        numbers = entry(err, ms, plain, nbytes(x, q, scale, got), 2 * m * n * k,
                        'bf16' if dtype == torch.bfloat16 else 'f32')
        extra = ''
        if dtype == torch.bfloat16:
            rerun_identical('woq_matmul', lambda: woq._woq_cuda(x, q, scale), got, what)
            w16 = q.to(dtype)
            linear = device_ms(lambda: F.linear(x, w16), iters=iters)
            scale_bf16 = scale.to(dtype)
            near = device_ms(lambda: torch._weight_int8pack_mm(x, q, scale_bf16),
                             iters=iters)
            extra = (f', yardsticks: F.linear on the bf16-widened weight {linear:.4f} ms, '
                     f'torch._weight_int8pack_mm (bf16 scales) {near:.4f} ms')
        log(f'[kernel] woq_matmul {what}: device kernel {ms:.4f} ms, twin {plain:.4f} ms'
            f'{extra}, bound {numbers["bound_ms"]:.4f} ms ({numbers["bound_by"]}); events '
            f'{ev:.4f} ms')
        if (m, k, n) == (1, 1280, 5120):
            results['woq_matmul'] = numbers
        elif (m, k, n) in ((3000, 1280, 5120), (12000, 1280, 5120)):
            results['woq_matmul'][f'M={m}'] = numbers


def vocab_checks(torch, results: dict, randn) -> None:
    """The vocab projection of the beam and sampled steps: x (M, 1280) bf16
    against emb (51866, 1280) bf16, M = 1, 5, 16 (beam and best_of steps),
    20 (the batched driver's beam step: 4 windows of 5 beams) and 64, 256,
    on the tensor-core kernel; one
    f32 shape on the CUDA-core kernel. f32 logits within 1e-4 relative to
    the largest (f32 sums of the same exact products); bf16 reruns
    bit-identical. Device times and events beside the library call."""
    from stable_ts_tpu_torch.ops import vocab_proj as vp
    emb = (randn(51866, 1280) * 0.02).to(torch.bfloat16)
    for m in (1, 5, 16, 20, 64, 256):
        x = randn(m, 1280, dtype=torch.bfloat16)
        got = vp.vocab_proj(x, emb)
        ref = vp.vocab_proj_ref(x, emb)
        torch.cuda.synchronize()
        what = f'M={m} emb (51866,1280) bf16'
        err = check('vocab_proj', got, ref, 1e-4, what)
        rerun_identical('vocab_proj', lambda: vp.vocab_proj(x, emb), got, what)
        ms, ev = both_ms(lambda: vp.vocab_proj(x, emb), iters=100)
        plain = device_ms(lambda: vp.vocab_proj_ref(x, emb), iters=20)
        # the library call: one bf16 product with f32 output
        lib, lib_ev = both_ms(lambda: torch.mm(x, emb.t(), out_dtype=torch.float32),
                              iters=100)
        numbers = entry(err, ms, plain, nbytes(x, emb, got), 2 * m * 51866 * 1280,
                        'bf16', lib)
        log(f'[kernel] vocab_proj {what}: device kernel {ms:.4f} ms, twin {plain:.4f} ms, '
            f'torch.mm(out_dtype=float32) {lib:.4f} ms, bound {numbers["bound_ms"]:.4f} ms '
            f'({numbers["bound_by"]}); events {ev:.4f} ms, torch.mm {lib_ev:.4f} ms')
        if m == 5:
            results['vocab_proj'] = numbers
        elif m == 20:
            results['vocab_proj']['M=20'] = numbers
    x, emb32 = randn(5, 1280), randn(4100, 1280) * 0.02
    check('vocab_proj', vp.vocab_proj(x, emb32), vp.vocab_proj_ref(x, emb32), 1e-4,
          'M=5 emb (4100,1280) f32 (CUDA cores)')


def flash_bwd_checks(torch, results: dict, randn) -> None:
    """The flash backward at the train step's large-v3 shapes (20 heads of
    64, bf16): encoder self-attention (2, 1500, 1280) against 1500 keys,
    decoder cross-attention (2, 63, 1280) against 1500 frames, and one f32
    shape. The forward's lse against the twin's logsumexp; both backward
    kernels, fed the kernel's own output, against the backward twin, within
    2e-2 (bf16: the gradients round to bf16, 2^-8 relative) or 1e-4 (f32:
    sums in another order) of each tensor's max; and a rerun equal bit for
    bit (no atomics). Times, each by its device time alone (the profiler's
    kernel durations) and by events: each kernel, its twin (the twin
    computing only that kernel's outputs), the bound, and the backward alone
    of PyTorch's fused attention on the same (B, heads, T, d_head) views."""
    import torch.nn.functional as F
    from stable_ts_tpu_torch.ops import flash_attn as fa
    d, h = 1280, 20
    dh = d // h
    scale = dh ** -0.5
    for b, t, what, dtype, tol in (
            (2, 1500, 'encoder bf16 (2,1500,1280)', torch.bfloat16, 2e-2),
            (2, 63, 'cross bf16 (2,63,1280)x1500', torch.bfloat16, 2e-2),
            (1, 300, 'f32 (1,300,1280)x1500', torch.float32, 1e-4)):
        s = 1500
        q, do = randn(b, t, d, dtype=dtype), randn(b, t, d, dtype=dtype)
        k, v = randn(b, s, d, dtype=dtype), randn(b, s, d, dtype=dtype)
        o, lse = fa._flash_cuda(q, k, v, h, scale, return_lse=True)
        _, lse_ref = fa.flash_attention_ref(q, k, v, h, scale, return_lse=True)
        torch.cuda.synchronize()
        check('flash_attn', lse, lse_ref, 1e-5, f'{what} lse')
        delta = fa.attention_delta(o, do, h)
        args = (q, k, v, lse, do, delta, h, scale)
        dk, dv = fa._bwd_dkv_cuda(*args)
        dq = fa._bwd_dq_cuda(*args)
        ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, h, scale)
        torch.cuda.synchronize()
        err_kv = max(check('flash_attn_bwd_dkv', dk, ref_dk, tol, f'{what} dK'),
                     check('flash_attn_bwd_dkv', dv, ref_dv, tol, f'{what} dV'))
        err_q = check('flash_attn_bwd_dq', dq, ref_dq, tol, f'{what} dQ')
        dk2, dv2 = fa._bwd_dkv_cuda(*args)
        dq2 = fa._bwd_dq_cuda(*args)
        torch.cuda.synchronize()
        same = torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)
        log(f'[kernel] flash backward {what}: rerun bit-identical: {same}')
        if not same:
            raise AssertionError(f'flash backward {what}: a rerun differs')
        # the library call: the backward alone of PyTorch's fused attention
        # on the same tensors viewed as (B, heads, T, d_head); graph built once
        qh, kh, vh = (x.view(b, -1, h, dh).transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
        doh = do.view(b, t, h, dh).transpose(1, 2)
        calls = (lambda: fa._bwd_dkv_cuda(*args), lambda: fa._bwd_dq_cuda(*args),
                 lambda: torch.autograd.grad(out, (kh, vh), doh, retain_graph=True),
                 lambda: torch.autograd.grad(out, (qh,), doh, retain_graph=True),
                 lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True))
        # device time alone (the profiler's kernel durations) and events
        ms_kv, ms_q, lib_kv, lib_q, lib_all = (device_ms(fn) for fn in calls)
        ev_kv, ev_q, _, _, ev_all = (cuda_ms(fn) for fn in calls)
        plain_kv = device_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, o, lse, do, h, scale, needs=(False, True, True)), iters=5)
        plain_q = device_ms(lambda: fa.flash_attention_bwd_ref(
            q, k, v, o, lse, do, h, scale, needs=(True, False, False)), iters=5)
        del out
        kind = 'bf16' if dtype == torch.bfloat16 else 'f32'
        # each input read once (q, k, v, dO, lse, D), each output written once
        inputs = nbytes(q, k, v, do, lse, delta)
        work = b * t * s * d
        n_kv = entry(err_kv, ms_kv, plain_kv, inputs + nbytes(dk, dv), 8 * work, kind, lib_kv)
        n_q = entry(err_q, ms_q, plain_q, inputs + nbytes(dq), 6 * work, kind, lib_q)
        whole = bound(inputs + nbytes(dq, dk, dv), 10 * work, kind)
        log(f'[kernel] flash backward {what}, device times: dkv {ms_kv:.4f} ms (twin '
            f'{plain_kv:.4f}, SDPA backward dK,dV {lib_kv:.4f}, bound {n_kv["bound_ms"]:.4f} '
            f'{n_kv["bound_by"]}); dq {ms_q:.4f} ms (twin {plain_q:.4f}, SDPA backward '
            f'dQ {lib_q:.4f}, bound {n_q["bound_ms"]:.4f} {n_q["bound_by"]}); both '
            f'{ms_kv + ms_q:.4f} ms against SDPA backward dQ,dK,dV {lib_all:.4f} ms '
            f'(bound {whole["bound_ms"]:.4f} {whole["bound_by"]}); events: dkv {ev_kv:.4f}, '
            f'dq {ev_q:.4f}, SDPA backward dQ,dK,dV {ev_all:.4f} ms')
        if t == 1500:
            results['flash_attn_bwd_dkv'] = n_kv
            results['flash_attn_bwd_dq'] = n_q


def tiny_train_parity(torch) -> None:
    """The tiny f32 model (seeded) takes three train steps on the CPU (every
    op through its twin) and on the card (the kernels), the second with a
    label mask: the losses within 1e-4 relative, and step 1's gradients
    within 1e-3 of each tensor's max (f32 sums in other orders)."""
    import numpy as np
    from stable_ts_tpu_torch.models.whisper.dims import tiny_test_dims
    from stable_ts_tpu_torch.models.whisper.model import init_params
    from stable_ts_tpu_torch.models.whisper.train import make_train_step
    dims = tiny_test_dims()
    cpu = init_params(dims, seed=0, device='cpu')
    gpu = copy.deepcopy(cpu).to('cuda')
    rng = np.random.default_rng(31)
    mel = rng.standard_normal((2, dims.n_mels, 3000)).astype(np.float32)
    tokens = rng.integers(0, dims.n_vocab, (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[:, :3] = 0
    init_opt_state, train_step = make_train_step(dims)
    opt_c, opt_g = init_opt_state(cpu), init_opt_state(gpu)
    for i in range(3):
        m = mask if i == 1 else None
        lc = train_step(cpu, opt_c, mel, tokens, m).item()
        lg = train_step(gpu, opt_g, mel, tokens, m).item()
        rel = abs(lg - lc) / abs(lc)
        worst = 0.0
        if i == 0:
            for pc, pg in zip(cpu.parameters(), gpu.parameters()):
                worst = max(worst, rel_err(pg.grad.cpu(), pc.grad)[1])
        ok = rel <= 1e-4 and worst <= 1e-3
        log(f'[tiny] train step {i + 1}{" (label mask)" if m is not None else ""}: '
            f'loss CPU {lc:.6f}, GPU {lg:.6f}, rel {rel:.2e} (tol 1e-4)'
            + (f'; worst gradient {worst:.2e} of its max (tol 1e-3)' if i == 0 else '')
            + f' {"OK" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'tiny train step {i + 1}: GPU differs from CPU')


def train_path(torch, dims, audio) -> dict:
    """The train step on large-v3 at full width (random bf16 weights from
    seed 0): three steps of ``make_train_step(dims)`` with its default
    AdamW, batch 2 windows (the log-mel of two 30-s clips) and 64 seeded
    tokens, the second step with the first 3 positions masked. Each step
    must launch exactly 64 flash forwards, 64 dkv and 64 dq backward
    kernels; after step 1 every parameter must hold a finite, non-zero
    gradient; every loss must be finite. A fourth step (no mask) and the
    encoder forward of one window run under torch.profiler for the device's
    busy share. Returns the launches summed over the steps."""
    import numpy as np
    from stable_ts_tpu_torch import _build
    from stable_ts_tpu_torch.models.whisper import train
    from stable_ts_tpu_torch.models.whisper.model import encoder_apply, init_params
    from stable_ts_tpu_torch.ops.mel import log_mel_spectrogram
    torch.cuda.reset_peak_memory_stats()
    log(f'[train] device memory allocated before the path: '
        f'{torch.cuda.memory_allocated() / 1e9:.3f} GB')
    t0 = time.perf_counter()
    model = init_params(dims, seed=0, dtype=torch.bfloat16)   # on the card by default
    init_opt_state, train_step = train.make_train_step(dims)
    opt = init_opt_state(model)
    clips = np.stack([audio[:30 * SR], audio[30 * SR:60 * SR]])
    mel = log_mel_spectrogram(clips, n_mels=dims.n_mels, device='cuda')
    tokens = np.random.default_rng(5).integers(0, dims.n_vocab, (2, 64))
    mask = np.ones((2, 64), np.int64)
    mask[:, :3] = 0
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    log(f'[train] bf16 model of {n_params / 1e9:.3f} B parameters and AdamW in '
        f'{time.perf_counter() - t0:.1f} s; mel {tuple(mel.shape)}, tokens {tokens.shape}')
    marks = {}

    def timed(fn, start, end):
        def inner(*a, **kw):
            torch.cuda.synchronize()
            marks[start] = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            marks[end] = time.perf_counter()
            return out
        return inner

    loss_fn = train.cross_entropy_loss
    train.cross_entropy_loss = timed(loss_fn, 'fwd0', 'fwd1')
    opt.step = timed(opt.step, 'opt0', 'opt1')
    counts = {}
    try:
        for i in range(3):
            m = mask if i == 1 else None
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = train_step(model, opt, mel, tokens, m).item()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            step_counts = _build.launch_counts()
            log(f'[train] step {i + 1}{" (label mask)" if m is not None else ""}: '
                f'loss {loss:.4f}, wall {wall:.3f} s: forward '
                f'{marks["fwd1"] - marks["fwd0"]:.3f} s, backward '
                f'{marks["opt0"] - marks["fwd1"]:.3f} s, optimizer '
                f'{marks["opt1"] - marks["opt0"]:.3f} s; launches {step_counts}')
            if not np.isfinite(loss):
                raise AssertionError(f'train step {i + 1}: loss {loss}')
            for name in ('flash_attn', 'flash_attn_bwd_dkv', 'flash_attn_bwd_dq'):
                if step_counts.get(name, 0) != 64:
                    raise AssertionError(f'train step {i + 1}: {name} launched '
                                         f'{step_counts.get(name, 0)} times, not 64')
            if i == 0:
                bad = [name for name, p in model.named_parameters()
                       if p.grad is None or not bool(torch.isfinite(p.grad).all())
                       or p.grad.float().norm().item() == 0.0]
                n_tensors = sum(1 for _ in model.parameters())
                log(f'[train] after step 1: {n_tensors - len(bad)} of {n_tensors} '
                    f'parameter tensors hold a finite, non-zero gradient')
                if bad:
                    raise AssertionError(f'missing, non-finite or zero gradients: {bad[:10]}')
            for name, n in step_counts.items():
                counts[name] = counts.get(name, 0) + n
        # where a step's time goes: a fourth step, and the encoder forward of
        # one window, under the profiler (device busy share, flash's part)
        _build.reset_launch_counts()
        loss, wall, busy, flash, top = profiled(
            lambda: train_step(model, opt, mel, tokens, None).item())
        step_counts = _build.launch_counts()
        if not np.isfinite(loss) or any(step_counts.get(name, 0) != 64 for name in (
                'flash_attn', 'flash_attn_bwd_dkv', 'flash_attn_bwd_dq')):
            raise AssertionError(f'profiled train step: loss {loss}, launches {step_counts}')
        for name, n in step_counts.items():
            counts[name] = counts.get(name, 0) + n
        log(f'[train] step 4 under torch.profiler: loss {loss:.4f}, wall {wall:.3f} s '
            f'(profiler on), device busy {busy:.3f} s ({busy / wall:.1%}), of it the flash '
            f'kernels {flash:.4f} s; top kernels (name, calls, ms) {top}')
        with torch.no_grad():
            _, wall, busy, flash, top = profiled(lambda: encoder_apply(model.encoder, mel[:1]))
        log(f'[train] encoder forward of one window (bf16, no grad) under torch.profiler: '
            f'wall {wall * 1e3:.2f} ms, device busy {busy * 1e3:.2f} ms ({busy / wall:.1%}), '
            f'of it flash {flash * 1e3:.3f} ms; top kernels {top}')
    finally:
        train.cross_entropy_loss = loss_fn
    log(f'[train] peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB')
    return counts


def tiny_parity(torch) -> None:
    """The tiny f32 model transcribes the same seeded audio alike on the
    CPU (every op through its twin) and on the GPU (through the kernels):
    with float weights on int8 cross K/V, quantized (dq) on packed int4
    cross K/V, with no known alignment heads (6 selected dynamically per
    token), with the 'new' aligner, and with an extra model."""
    import numpy as np
    from stable_ts_tpu_torch.loaders import WhisperTorch, load_test_model
    audio = (np.random.default_rng(21).standard_normal(SR * 40) * 0.1
             ).astype(np.float32)
    extra_cpu = load_test_model(seed=1, device='cpu', alignment_heads=None)
    extra_gpu = WhisperTorch(extra_cpu.dims, copy.deepcopy(extra_cpu.params),
                             device='cuda', name='test-tiny', ranks=extra_cpu._ranks)
    for dq, kv_quant, heads, options, what in (
            (False, True, HEADS_TINY, {}, 'f32 weights, int8 cross K/V'),
            (True, 4, HEADS_TINY, {}, 'int8 weights (dq), int4 cross K/V'),
            (False, True, None, {}, 'f32 weights, int8 cross K/V, no alignment heads'),
            (False, True, HEADS_TINY, dict(aligner='new'), "f32 weights, aligner='new'"),
            (False, True, HEADS_TINY, 'extra', 'f32 weights, an extra model (no heads)')):
        cpu = load_test_model(seed=0, device='cpu', alignment_heads=heads, dq=dq)
        gpu = WhisperTorch(cpu.dims, copy.deepcopy(cpu.params), device='cuda',
                           name='test-tiny', ranks=cpu._ranks, alignment_heads=heads)
        if gpu.quantized != dq:
            raise AssertionError(f'tiny model: quantized {gpu.quantized} != {dq}')
        kw = dict(language='en', temperature=0, verbose=None, kv_quant=kv_quant)
        kw_c, kw_g = ((dict(kw, extra_models=[extra_cpu]), dict(kw, extra_models=[extra_gpu]))
                      if options == 'extra' else (dict(kw, **options), dict(kw, **options)))
        rc, rg = cpu.transcribe(audio, **kw_c), gpu.transcribe(audio, **kw_g)
        words_c = [(w.start, w.end) for s in rc.segments for w in s.words]
        words_g = [(w.start, w.end) for s in rg.segments for w in s.words]
        worst = max((max(abs(a[0] - b[0]), abs(a[1] - b[1]))
                     for a, b in zip(words_c, words_g)), default=0.0)
        ok = (rc.text == rg.text and len(words_c) == len(words_g) > 0
              and worst <= 0.021)
        log(f'[tiny] tiny model, {what}, 40 s: CPU twins vs GPU kernels: text '
            f'equal {rc.text == rg.text}, {len(words_c)} vs {len(words_g)} words, '
            f'worst word-time gap {worst:.3f} s (bound 0.021) {"OK" if ok else "FAIL"}')
        if not ok:
            raise AssertionError(f'tiny model ({what}): GPU transcription differs '
                                 'from CPU')


def check_result(result, srt: str, duration: float) -> int:
    words = [w for s in result.segments for w in s.words]
    if not srt.strip() or not words:
        raise AssertionError('empty word-level SRT')
    prev = 0.0
    for w in words:
        if not (0.0 <= w.start <= w.end <= duration + 1e-6):
            raise AssertionError(f'word {w.word!r} at {w.start}-{w.end} outside '
                                 f'[0, {duration}] or reversed')
        if w.start < prev - 1e-6:
            raise AssertionError(f'word starts decrease at {w.start} < {prev}')
        prev = w.start
    return len(words)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device (torch.cuda.is_available() is False)',
              file=sys.stderr)
        return 2
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f'[env] python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from stable_ts_tpu_torch import _build
    started = t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f'[build] {lib_path.relative_to(HERE)} in {time.perf_counter() - t0:.1f} s')
    for name, r in _build.kernel_resources(lib_path).items():
        log(f'[build] ptxas {name}: {r}')

    results = {}
    kernel_checks(torch, results)
    dyn_checks(torch)
    tiny_parity(torch)
    tiny_train_parity(torch)

    # -- the paths on large-v3: greedy, beam with language detection, ladder -----------
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper import alignment_heads
    from stable_ts_tpu_torch.models.whisper.dims import (OPENAI_MODEL_DIMS,
                                                         ModelDimensions)
    from stable_ts_tpu_torch.models.whisper.model import init_params

    dims = ModelDimensions(**OPENAI_MODEL_DIMS[MODEL])
    t0 = time.perf_counter()
    params = init_params(dims, seed=0, dtype=torch.bfloat16, device='cuda')
    ranks = synthetic_ranks()
    model = WhisperTorch(dims, params, device='cuda', name=MODEL, ranks=ranks,
                         alignment_heads=alignment_heads.get_alignment_heads(
                             MODEL, dims.n_text_layer, dims.n_text_head))
    torch.cuda.synchronize()
    log(f'[model] {model} built in {time.perf_counter() - t0:.1f} s, '
        f'{len(model.alignment_heads)} alignment heads')
    step_graph_checks(torch, model, results)

    from stable_ts_tpu_torch.audio.synth import synth_speech_like
    audio = synth_speech_like(155.0)
    ladder = (0.0, 0.4, 0.8)
    beam_clip = audio[95 * SR:115 * SR]
    # (path, request label, clip, transcribe options, kernels the path must launch)
    paths = [
        ('greedy', [('75 s', audio[:75 * SR]), ('20 s', audio[75 * SR:95 * SR])],
         dict(language='en', temperature=0),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue',
          'dtw_cost')),
        ('beam', [('20 s, no language, beam_size=5', beam_clip)],
         dict(temperature=0, beam_size=5),
         ('flash_attn', 'self_attn_decode_beam', 'cross_attn_decode_group',
          'vocab_proj', 'dtw_cost')),
        ('ladder', [('30 s, temperature=(0.0, 0.4, 0.8), best_of=5',
                     audio[125 * SR:155 * SR])],
         dict(language='en', temperature=ladder, best_of=5),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue',
          'cross_attn_decode_group', 'vocab_proj', 'dtw_cost')),
    ]
    sequential = []
    counts = drive_paths(torch, model, paths, ladder, sequential)

    # -- forced alignment: align the 20-s transcript, align_words over 60 s -------------
    align_segments = align_words_grid(60.0)
    align_counts, aligned_60 = align_paths(torch, model, audio, sequential[1],
                                           align_segments)
    for name, n in align_counts.items():
        counts[name] = counts.get(name, 0) + n

    # -- locate the start of the 75-s transcript ----------------------------------------
    for name, n in locate_paths(torch, model, audio, sequential[0]).items():
        counts[name] = counts.get(name, 0) + n

    # -- no known heads: the same weights, 6 heads selected per token ------------------
    no_heads = WhisperTorch(dims, params, device='cuda', name=MODEL + '-no-heads',
                            ranks=ranks, alignment_heads=None)
    no_heads_paths = [
        ('no heads', [('10 s greedy, language=en, 6 dynamic heads', audio[:10 * SR])],
         dict(language='en', temperature=0),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue',
          'dtw_cost')),
    ]
    for name, n in drive_paths(torch, no_heads, no_heads_paths, ladder).items():
        counts[name] = counts.get(name, 0) + n
    del no_heads

    # -- a checkpoint written and loaded; the 'new' aligner; an extra model ----------------
    for name, n in checkpoint_paths(torch, model, ranks, audio, ladder,
                                    sequential[1]).items():
        counts[name] = counts.get(name, 0) + n

    # -- the batched driver: window groups through transcribe_batched -----------------
    no_heads = WhisperTorch(dims, params, device='cuda', name=MODEL + '-no-heads',
                            ranks=ranks, alignment_heads=None)
    long_audio = synth_speech_like(300.0)
    batched = [
        ('batched greedy', model, long_audio,
         dict(batch_size=8, language='en', temperature=0),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue', 'dtw_cost')),
        ('batched beam', model, long_audio[:90 * SR],
         dict(batch_size=4, beam_size=5, temperature=0),
         ('flash_attn', 'self_attn_decode_beam', 'cross_attn_decode_group', 'vocab_proj',
          'dtw_cost')),
        ('batched ladder', model, long_audio[90 * SR:150 * SR],
         dict(batch_size=2, language='en', temperature=ladder, best_of=5),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue', 'dtw_cost')),
        ('batched no heads', no_heads, long_audio[150 * SR:210 * SR],
         dict(batch_size=2, language='en', temperature=0, dynamic_heads='6,2'),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue', 'dtw_cost')),
        ('batched new aligner', model, long_audio[150 * SR:210 * SR],
         dict(batch_size=2, language='en', temperature=0, aligner='new'),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue', 'dtw_cost')),
    ]
    batched_reqs = {}
    for name, n in batched_paths(torch, batched, batched_reqs).items():
        counts[name] = counts.get(name, 0) + n
    decode_busy_share(torch, model, long_audio)
    del no_heads, batched   # the requests hold the models (dq quantizes in place)
    greedy_75 = sequential[0]
    seq_rate = greedy_75['wall'] / greedy_75['duration']
    batched_rate = batched_reqs['batched greedy']['s_per_audio_s']
    log(f'[batched] seconds per audio second, same run: batched greedy (300 s, groups of 8) '
        f'{batched_rate:.4f} against the sequential greedy {greedy_75["label"]} '
        f'{seq_rate:.4f} ({seq_rate / batched_rate:.2f}x)')

    # -- refine the batched greedy 300-s result, on the weights and an f32 copy ----------
    f32_model = WhisperTorch(dims, init_params(dims, seed=0, dtype=torch.float32,
                                               device='cuda'),
                             device='cuda', name=MODEL + '-f32', ranks=ranks,
                             alignment_heads=model.alignment_heads)
    for name, n in refine_paths(torch, {'bf16': model, 'f32': f32_model}, long_audio,
                                batched_reqs['batched greedy']).items():
        counts[name] = counts.get(name, 0) + n
    del f32_model

    # -- a world of one over NCCL: the sharded code path, bit for bit the unsharded ----
    heads = model.alignment_heads
    mesh_counts, mesh = mesh_one(torch, dims, ranks, heads, model, audio, long_audio,
                                 batched_reqs, aligned_60, align_segments)
    for name, n in mesh_counts.items():
        counts[name] = counts.get(name, 0) + n

    # -- the dq path: the same weights quantized on the card, int4 cross K/V -------------
    from stable_ts_tpu_torch.models.whisper.quantization import quantized_bytes
    float_bytes = quantized_bytes(model.params)
    t0 = time.perf_counter()
    dq_model = WhisperTorch(dims, model.params, device='cuda', name=MODEL + '-dq',
                            ranks=ranks, alignment_heads=model.alignment_heads,
                            dq=True)
    del model   # its params are now dq_model's, quantized in place
    torch.cuda.synchronize()
    log(f'[model] dq: quantized on the card in {time.perf_counter() - t0:.1f} s, '
        f'{float_bytes / 1e9:.3f} GB of parameters -> '
        f'{quantized_bytes(dq_model.params) / 1e9:.3f} GB')
    if not dq_model.quantized:
        raise AssertionError('dq=True left the model unquantized')
    dq_paths = [
        ('dq', [('20 s greedy, language=en, kv_quant=4', beam_clip,
                 dict(language='en', temperature=0, kv_quant=4)),
                ('20 s, no language, beam_size=5, kv_quant=4', beam_clip,
                 dict(temperature=0, beam_size=5, kv_quant=4))],
         None,
         ('flash_attn', 'woq_matmul', 'self_attn_decode', 'cross_attn_decode_int4',
          'logit_epilogue', 'self_attn_decode_beam', 'cross_attn_decode_group_int4',
          'vocab_proj', 'dtw_cost')),
    ]
    dq_requests = []
    for name, n in drive_paths(torch, dq_model, dq_paths, ladder, dq_requests).items():
        counts[name] = counts.get(name, 0) + n
    for name, n in dyn_request(torch, dq_model, beam_clip, ladder,
                               dq_requests[0]).items():
        counts[name] = counts.get(name, 0) + n
    for name, n in batched_paths(torch, [
            ('batched dq', dq_model, long_audio[210 * SR:270 * SR],
             dict(batch_size=2, language='en', temperature=0, kv_quant=4),
             ('flash_attn', 'woq_matmul', 'cross_attn_decode_int4', 'logit_epilogue',
              'self_attn_decode', 'dtw_cost'))], batched_reqs).items():
        counts[name] = counts.get(name, 0) + n
    n_seg = len(align_segments)
    _, dq_counts, _ = run_align(
        torch, 'dq align_words', f'60 s, {n_seg} segments, parallel (the default)',
        lambda: dq_model.align_words(audio[:60 * SR], [dict(s) for s in align_segments],
                                     language='en', verbose=None),
        60.0, exact={'flash_attn': 64, 'dtw_cost': 1}, needed=('woq_matmul',))
    for name, n in dq_counts.items():
        counts[name] = counts.get(name, 0) + n
    _, dq_counts, _ = run_align(
        torch, 'dq refine', '60 s, the align_words result, prob_threshold=0.0, '
        'parallel (the default)',
        lambda: dq_model.refine(audio[:60 * SR], aligned_60, inplace=False,
                                prob_threshold=0.0, verbose=None),
        60.0, needed=('flash_attn', 'woq_matmul'))
    for name, n in dq_counts.items():
        counts[name] = counts.get(name, 0) + n
    word = locate_word(greedy_75)
    _, dq_counts = run_locate(
        torch, 'dq locate', f'mode 1, tokens {word} in 75 s, probability_threshold=0.0',
        lambda: dq_model.locate(audio[:75 * SR], word, language='en', verbose=None,
                                mode=1, probability_threshold=0.0),
        LOCATE_DECODE + ('woq_matmul',), seq_rate)
    for name, n in dq_counts.items():
        counts[name] = counts.get(name, 0) + n

    # -- the world of one: the batched dq request and two train steps, sharded --------
    del dq_model, params
    gc.collect()   # the timed methods drive_paths set refer to their model
    torch.cuda.empty_cache()
    for name, n in mesh_one_dq_and_train(torch, dims, ranks, heads, mesh, long_audio,
                                         batched_reqs, audio).items():
        counts[name] = counts.get(name, 0) + n

    # -- the train path: a fresh float model (the dq path quantized the old one) ---------
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in train_path(torch, dims, audio).items():
        counts[name] = counts.get(name, 0) + n

    # -- two ranks on the one card over gloo: tp = 2 and dp = 2, gated in f32 ----------
    del batched_reqs, aligned_60
    gc.collect()
    torch.cuda.empty_cache()
    for name, n in mesh_two(torch, heads).items():
        counts[name] = counts.get(name, 0) + n
    loaded = sorted(m for m in sys.modules if m in ('jax', 'optax', 'stable_ts_tpu')
                    or m.startswith(('jax.', 'optax.', 'stable_ts_tpu.')))
    if loaded:
        raise AssertionError(f'jax, optax or stable_ts_tpu was imported: {loaded[:10]}')

    src = 'stable_ts_tpu_torch/csrc/'
    meta = {
        'flash_attn': (src + 'flash_attn.cu',
                       'stable_ts_tpu/models/whisper/model.py:241 _flash_self_attention'
                       ' / :330 _flash_cross_attention (Pallas flash_attention)'),
        'self_attn_decode': (src + 'decode_attn.cu',
                             'stable_ts_tpu/ops/self_attn.py:68 _kernel'),
        'cross_attn_decode': (src + 'decode_attn.cu',
                              'stable_ts_tpu/ops/cross_attn.py:47 _kernel'),
        'dtw_cost': (src + 'dtw.cu', 'stable_ts_tpu/ops/dtw.py:111 _dtw_row_kernel'),
        'logit_epilogue': (src + 'logit_epilogue.cu',
                           'stable_ts_tpu/ops/logit_epilogue.py:59 _kernel'),
        'cross_attn_decode_group': (src + 'decode_attn.cu',
                                    'stable_ts_tpu/ops/cross_attn.py:47 _kernel'
                                    ' (q_per_kv > 1 branch, :108-142)'),
        'self_attn_decode_beam': (src + 'decode_attn.cu',
                                  'stable_ts_tpu/ops/self_attn.py:132 _kernel_beam'),
        'cross_attn_decode_int4': (src + 'decode_attn.cu',
                                   'stable_ts_tpu/ops/cross_attn.py:47 _kernel'
                                   ' (bits=4 branch, :60-75)'),
        'cross_attn_decode_group_int4': (src + 'decode_attn.cu',
                                         'stable_ts_tpu/ops/cross_attn.py:47 _kernel'
                                         ' (bits=4 and q_per_kv > 1 branches)'),
        'woq_matmul': (src + 'woq_matmul.cu',
                       'stable_ts_tpu/ops/woq_matmul.py:27 _kernel (int8_matmul :86)'),
        'vocab_proj': (src + 'vocab_proj.cu',
                       'stable_ts_tpu/ops/vocab_proj.py:34 _kernel'
                       ' (vocab_logits_kernel :46)'),
        'flash_attn_bwd_dkv': (src + 'flash_attn_bwd.cu',
                               'stable_ts_tpu/models/whisper/model.py:278 / :372 Pallas'
                               ' flash_attention backward: _flash_attention_bwd_dkv'
                               ' (flash_attention.py:941, pallas_call :1121)'),
        'flash_attn_bwd_dq': (src + 'flash_attn_bwd.cu',
                              'stable_ts_tpu/models/whisper/model.py:278 / :372 Pallas'
                              ' flash_attention backward: _flash_attention_bwd_dq'
                              ' (flash_attention.py:1287, pallas_call :1456)'),
    }
    kernels = [dict(name=name, route='cuda', source=meta[name][0],
                    replaces=meta[name][1], launches=counts.get(name, 0),
                    **results[name])
               for name in meta]
    log(f'[run] chip_smoke elapsed {time.perf_counter() - started:.1f} s')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def write_tiktoken(path: str, ranks: dict) -> None:
    """``ranks`` in the tiktoken rank-file format (one base64 token and its
    rank a line, as tokenizer.load_tiktoken_ranks reads it)."""
    import base64
    with open(path, 'w') as f:
        for token, rank in sorted(ranks.items(), key=lambda kv: kv[1]):
            f.write(f'{base64.b64encode(token).decode()} {rank}\n')


def checkpoint_paths(torch, model, ranks, audio, ladder, greedy_20: dict) -> dict:
    """Write ``model``'s weights as an OpenAI ``large-v3.pt`` beside a
    ``multilingual.tiktoken`` of ``ranks``; load it back with ``load_model``
    (bf16, on the card) and fail unless every parameter, the heads the file
    name resolves to and the vocabulary are the sources'. Then, on the
    loaded model, the 'new aligner' path (10 s greedy with the legacy
    aligner and known heads, then with aligner='new', on the same clip)
    and the 'extra models' path (the same legacy request with a second
    large-v3 of seed 1 as the extra model, which must add its 32 encoder
    and 32 capture-pass flash launches a window); then one window's
    encoder and 'new' aligner pass under ``profile_trace``, whose Chrome
    trace must name the flash and DTW kernels; then the command line on
    the written files (:func:`cli_paths`, with ``greedy_20``'s tokens as
    the target of ``--locate``). Returns the paths' kernel launches."""
    import tempfile
    from stable_ts_tpu_torch import load_model
    from stable_ts_tpu_torch.constants import N_FRAMES, N_SAMPLES
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper import alignment_heads
    from stable_ts_tpu_torch.models.whisper.load import save_openai_checkpoint
    from stable_ts_tpu_torch.models.whisper.model import init_params
    from stable_ts_tpu_torch.models.whisper.timing import find_alignment
    from stable_ts_tpu_torch.ops.mel import log_mel_spectrogram
    from stable_ts_tpu_torch.profiling import profile_trace
    dims = model.dims
    counts = {}

    def add(path_counts):
        for name, n in path_counts.items():
            counts[name] = counts.get(name, 0) + n

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, MODEL + '.pt')
        vocab = os.path.join(tmp, 'multilingual.tiktoken')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_openai_checkpoint(path, dims, model.params)
        write_s = time.perf_counter() - t0
        write_tiktoken(vocab, ranks)
        log(f'[checkpoint] wrote {MODEL}.pt (bf16, OpenAI layout): '
            f'{os.path.getsize(path) / 1e9:.3f} GB in {write_s:.3f} s')
        t0 = time.perf_counter()
        loaded = load_model(path, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        src = dict(model.params.named_parameters())
        got = dict(loaded.params.named_parameters())
        unequal = sorted(set(src) ^ set(got)) + [
            n for n in src if n in got and not (got[n].dtype == src[n].dtype
                                                and torch.equal(got[n], src[n]))]
        if unequal:
            raise AssertionError(f'loaded checkpoint differs from its source: {unequal[:5]}')
        want_heads = alignment_heads.get_alignment_heads(
            MODEL, dims.n_text_layer, dims.n_text_head)
        if loaded.alignment_heads != want_heads:
            raise AssertionError(f'heads from the file name: {loaded.alignment_heads}')
        if loaded._vocab_path != vocab or loaded.get_tokenizer('en').bpe.ranks != ranks:
            raise AssertionError(f'tokenizer not from the file beside the checkpoint: '
                                 f'{loaded._vocab_path}')
        log(f'[checkpoint] load_model(dtype=bfloat16) on {loaded.device} in '
            f'{load_s:.3f} s: {len(src)} parameters torch.equal to the source, '
            f'{len(want_heads or ())} heads from the name {MODEL!r}, the vocabulary '
            f'from {os.path.basename(vocab)} beside it')

        clip = audio[:10 * SR]
        greedy = dict(language='en', temperature=0)
        need = ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue',
                'dtw_cost')
        reqs = []
        add(drive_paths(torch, loaded, [
            ('new aligner', [('10 s greedy, legacy aligner, known heads', clip, greedy),
                             ("10 s greedy, aligner='new'", clip,
                              dict(greedy, aligner='new'))],
             None, need)], ladder, reqs))
        legacy, new = reqs
        missing = [k for k in need if new['launches'].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"aligner='new' request launched no {missing}")
        log(f'[new aligner] word timing of the same 10 s (one window each): legacy '
            f'{legacy["word_timing_s"]:.3f} s, peak +{legacy["word_timing_peak_bytes"] / 1e9:.3f} '
            f'GB; new {new["word_timing_s"]:.3f} s, peak '
            f'+{new["word_timing_peak_bytes"] / 1e9:.3f} GB')

        t0 = time.perf_counter()
        extra = WhisperTorch(dims, init_params(dims, seed=1, dtype=torch.bfloat16,
                                               device='cuda'),
                             device='cuda', name=MODEL + '-seed1', ranks=ranks,
                             alignment_heads=want_heads)
        torch.cuda.synchronize()
        log(f'[model] extra model {extra} built in {time.perf_counter() - t0:.1f} s')
        reqs = []
        add(drive_paths(torch, loaded, [
            ('extra models', [('10 s greedy, legacy aligner, known heads, '
                               'extra_models=[large-v3 seed 1]', clip,
                               dict(greedy, extra_models=[extra]))],
             None, ('flash_attn', 'dtw_cost'))], ladder, reqs))
        (mixed,) = reqs
        per_window = [r['launches'].get('flash_attn', 0) / max(r['windows'], 1)
                      for r in (legacy, mixed)]
        log(f'[extra models] flash launches a window: {per_window[1]:.1f} with the extra '
            f'model, {per_window[0]:.1f} without; word timing {mixed["word_timing_s"]:.3f} s, '
            f'peak +{mixed["word_timing_peak_bytes"] / 1e9:.3f} GB')
        # its encoder layers and its capture pass's cross layers (64 at large-v3)
        want = extra.dims.n_audio_layer + extra.dims.n_text_layer
        if per_window[1] - per_window[0] < want:
            raise AssertionError(f'the extra model added fewer than {want} flash '
                                 'launches a window')

        tokenizer = loaded.get_tokenizer('en', 'transcribe')
        text_tokens = tokenizer.encode(' a synthetic clip of speech-like noise')
        mel = log_mel_spectrogram(clip, dims.n_mels, padding=N_SAMPLES - clip.shape[-1],
                                  device=loaded.device)[..., :N_FRAMES]
        trace_dir = os.path.join(tmp, 'trace')
        with profile_trace(trace_dir):
            feats = loaded.embed_audio(mel)
            find_alignment(loaded.params, dims, tokenizer, text_tokens, mel,
                           clip.shape[-1], audio_features=feats, aligner='new')
        (trace,) = os.listdir(trace_dir)
        with open(os.path.join(trace_dir, trace)) as f:
            events = json.load(f)['traceEvents']
        kernels = {e['name'] for e in events if e.get('cat') == 'kernel'}
        found = {key: sorted(n for n in kernels if key in n)[:2]
                 for key in ('flash_fwd', 'dtw_cost_kernel')}
        log(f'[profile] profile_trace of one window (embed_audio + find_alignment, '
            f"aligner='new'): {os.path.getsize(os.path.join(trace_dir, trace)) / 1e6:.1f} MB, "
            f'{len(events)} events, {len(kernels)} kernel names; {found}')
        if not all(found.values()):
            raise AssertionError(f'the trace names no flash or DTW kernel: {found}')
        del loaded, extra, feats
        gc.collect()
        torch.cuda.empty_cache()
        add(cli_paths(torch, path, audio, tmp, greedy_20))
    return counts


def write_wav(path: str, clip) -> str:
    """``clip`` (f32 in [-1, 1] at 16 kHz) as a 16-bit mono WAV."""
    import wave
    import numpy as np
    with wave.open(path, 'wb') as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((np.clip(clip, -1.0, 1.0) * 32767).astype('<i2').tobytes())
    return path


CLI_FORMATS = ('srt', 'vtt', 'ass', 'tsv', 'txt', 'json')
CLI_GREEDY = ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue',
              'dtw_cost')


STARTUP_PROBE = '''
import json, time
t0 = time.perf_counter()
import torch
import stable_ts_tpu_torch.cli, stable_ts_tpu_torch.loaders
t1 = time.perf_counter()
torch.zeros(1, device='cuda')
torch.cuda.synchronize()
t2 = time.perf_counter()
from stable_ts_tpu_torch import _build
_build.lib()
t3 = time.perf_counter()
print(json.dumps(dict(imports=t1 - t0, cuda_context=t2 - t1, build_check=t3 - t2)))
'''


def cli_paths(torch, pt: str, audio, tmp: str, greedy_20: dict) -> dict:
    """The command line on the ``large-v3.pt`` and ``multilingual.tiktoken``
    that :func:`checkpoint_paths` wrote. First ``python -m
    stable_ts_tpu_torch`` as a subprocess on the 20-s clip (the greedy 20-s
    request's) written as a 16-bit WAV, bf16, all six formats: it must exit
    0 and write six non-empty files, and its SRT bytes must equal those of
    the same argv in this process; a second subprocess times the start-up
    alone (the imports, the CUDA context, the kernel library's build
    check). Then, in this process on the one model
    that ``_run_once``'s cache keeps loaded: ``transcribe_batched`` with
    ``batch_size=8`` on a 120-s WAV, ``--align`` of the 20-s TXT output,
    ``--align_words`` of the batched JSON, ``--refine`` of that alignment
    (``prob_threshold=0.0``), ``--locate`` of the first 4 tokens of the
    greedy 20-s transcript (``greedy_20``, :func:`locate_word`; mode 0,
    ``probability_threshold=0.0``) and ``-dq``
    greedy on the 20-s WAV (a second load). The launch counts are reset
    before each request and read after it; each must launch the kernels of
    the entry point it calls. Last, a JSON -> SRT request must launch
    nothing and call no ``load_model``. Returns the launches summed over
    the in-process requests."""
    import contextlib
    import io
    from stable_ts_tpu_torch import _build, loaders
    from stable_ts_tpu_torch.cli import _run_once, build_parser
    parser = build_parser()
    wav20 = write_wav(os.path.join(tmp, 'clip20.wav'), audio[75 * SR:95 * SR])
    wav120 = write_wav(os.path.join(tmp, 'clip120.wav'), audio[:120 * SR])
    model_args = ['--model', pt, '--dtype', 'bfloat16', '--language', 'en']
    argv = [wav20, *model_args, '--output_format', ','.join(CLI_FORMATS)]
    out = {name: os.path.join(tmp, 'cli_' + name) for name in ('sub', 'main', 'extra')}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, '-m', 'stable_ts_tpu_torch', *argv,
                           '--output_dir', out['sub'], '-y'],
                          cwd=HERE, capture_output=True, text=True, timeout=900)
    sub_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f'python -m stable_ts_tpu_torch exited {proc.returncode}: '
                             f'{proc.stderr[-2000:]}')
    sizes = {fmt: os.path.getsize(os.path.join(out['sub'], f'clip20.{fmt}'))
             for fmt in CLI_FORMATS}
    if not all(sizes.values()):
        raise AssertionError(f'the subprocess wrote an empty file: {sizes}')
    t0 = time.perf_counter()
    probe = subprocess.run([sys.executable, '-c', STARTUP_PROBE], cwd=HERE,
                           capture_output=True, text=True, timeout=300, check=True)
    startup = dict(json.loads(probe.stdout.strip().splitlines()[-1]),
                   process=time.perf_counter() - t0)

    counts, loads, cache = {}, [], {}
    load_model = loaders.load_model

    def timed_load(**kw):
        t = time.perf_counter()
        model = load_model(**kw)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t)
        return model

    def request(label, args, needed=(), quiet=True):
        """One in-process request; returns (wall, launches, its stdout)."""
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        printed = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stdout(printed), contextlib.redirect_stderr(io.StringIO()):
            _run_once(parser.parse_args(args + (['-v', '0'] if quiet else [])), cache)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        launches = _build.launch_counts()
        log(f'[cli] {label}: wall {wall:.3f} s; launches {launches}')
        missing = [k for k in needed if launches.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f'cli {label}: no {missing} launched')
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n
        return wall, launches, printed.getvalue()

    loaders.load_model = timed_load
    try:
        main_wall, _, _ = request('the subprocess argv, 20 s (the fallback ladder)',
                                  argv + ['--output_dir', out['main'], '-y'], CLI_GREEDY,
                                  quiet=False)
        log(f'[cli] python -m stable_ts_tpu_torch (20 s, bf16, six formats) as a '
            f'subprocess: wall {sub_wall:.3f} s (start-up, imports, build check, load, '
            f'request); the same argv in this process {main_wall:.3f} s, of which '
            f'load_model {loads[0]:.3f} s; a start-up alone in a subprocess '
            f'{startup["process"]:.3f} s: imports {startup["imports"]:.3f} s, CUDA '
            f'context {startup["cuda_context"]:.3f} s, build check '
            f'{startup["build_check"]:.3f} s; files {sizes}')
        for fmt in ('srt',):
            with open(os.path.join(out['sub'], f'clip20.{fmt}'), 'rb') as f:
                sub_bytes = f.read()
            with open(os.path.join(out['main'], f'clip20.{fmt}'), 'rb') as f:
                main_bytes = f.read()
            if sub_bytes != main_bytes:
                raise AssertionError(f'cli: the subprocess and the in-process {fmt} differ')
        log(f'[cli] subprocess and in-process SRT bytes equal ({len(sub_bytes)} bytes)')

        greedy = ['--temperature_increment_on_fallback', 'None', '-y']
        batched_dir = os.path.join(out['extra'], 'batched')
        request('transcribe_batched, batch_size=8, 120 s, greedy',
                [wav120, *model_args, '--transcribe_method', 'transcribe_batched',
                 '--batch_size', '8', '-f', 'json,srt', '-d', batched_dir, *greedy],
                CLI_GREEDY)
        batched_json = os.path.join(batched_dir, 'clip120.json')
        request('--align of the 20-s TXT output',
                [wav20, *model_args, '--align', os.path.join(out['main'], 'clip20.txt'),
                 '-f', 'srt', '-d', os.path.join(out['extra'], 'align'), '-y'],
                ('flash_attn', 'dtw_cost'))
        request('--align_words of the batched JSON, 120 s',
                [wav120, *model_args, '--align_words', batched_json, '-f', 'srt',
                 '-d', os.path.join(out['extra'], 'align_words'), '-y'],
                ('flash_attn', 'dtw_cost'))
        request('--align_words of the batched JSON, then --refine (prob_threshold=0.0)',
                [wav120, *model_args, '--align_words', batched_json, '--refine',
                 '--refine_option', 'prob_threshold=0.0', '-f', 'srt',
                 '-d', os.path.join(out['extra'], 'refine'), '-y'],
                ('flash_attn', 'dtw_cost'))
        stream = locate_word(greedy_20)
        model = cache['model']
        text = model.get_tokenizer('en', 'transcribe').decode(stream)
        _, _, printed = request(
            f'--locate of tokens {stream} of the greedy 20-s transcript (mode 0, '
            'probability_threshold=0.0)',
            [wav20, *model_args, '--locate', text, '--locate_option',
             'probability_threshold=0.0', '-y'],
            LOCATE_DECODE + ('dtw_cost',))
        if not printed.strip():
            raise AssertionError('cli --locate printed no match')
        del model
        request('-dq greedy, 20 s (a second load: int8 weights)',
                [wav20, *model_args, '-dq', '-f', 'srt',
                 '-d', os.path.join(out['extra'], 'dq'), *greedy],
                CLI_GREEDY + ('woq_matmul',))
        log(f'[cli] load_model calls: {len(loads)} ({", ".join(f"{s:.3f} s" for s in loads)})')
        if len(loads) != 2:
            raise AssertionError(f'cli: {len(loads)} loads, expected one float and one dq')
    finally:
        loaders.load_model = load_model
        cache.clear()

    def no_load(**kw):
        raise AssertionError('a JSON input loaded a model')
    loaders.load_model = no_load
    try:
        _, launches, _ = request('JSON -> SRT (no model)',
                                 [batched_json, '-o', os.path.join(out['extra'], 'json.srt'),
                                  '-y'])
    finally:
        loaders.load_model = load_model
    if any(launches.values()) or cache:
        raise AssertionError(f'cli JSON -> SRT launched {launches}')
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def dyn_checks(torch) -> None:
    """The dyn recipe of dq (STABLE_TS_TPU_WOQ=dyn: int8 activations x the
    int8 weight, ``torch._int_mm``) at large-v3's linear shapes: M = 1, 5,
    20, 1500, 3000 rows over (K, N) = (1280, 5120), (5120, 1280), (1280,
    1280). The card's int32 sums must equal the CPU's of the same int8
    operands bit for bit, the bf16 output must match the CPU's run of the
    same function within 1e-6 of its largest value, and a rerun must be
    bit-identical. Each shape's device time is logged beside woq_matmul's
    and F.linear's on the weight widened to bf16 (one PyTorch call), with
    its bound (int8 operations at the data sheet's 1,979 TOP/s), and the
    rows padded to 17 are timed against _int_mm on rows already padded."""
    from stable_ts_tpu_torch.models.whisper.quantization import (INT_MM_MIN_ROWS,
                                                                 dyn_linear, int8_mm,
                                                                 quantize_rows)
    from stable_ts_tpu_torch.ops.woq_matmul import woq_matmul
    gen = torch.Generator(device='cuda').manual_seed(13)
    for k, n in ((1280, 5120), (5120, 1280), (1280, 1280)):
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8, device='cuda', generator=gen)
        scale = torch.rand(n, device='cuda', generator=gen) * 1e-3 + 1e-4
        bias = torch.randn(n, device='cuda', generator=gen).to(torch.bfloat16)
        w16 = (w.float() * scale[:, None]).to(torch.bfloat16)
        for m in (1, 5, 20, 1500, 3000):
            x = torch.randn(m, k, device='cuda', generator=gen).to(torch.bfloat16)
            xq, _ = quantize_rows(x)
            sums = int8_mm(xq, w)
            torch.cuda.synchronize()
            if not torch.equal(sums.cpu(), int8_mm(xq.cpu(), w.cpu())):
                raise AssertionError(f'dyn ({m}, {k}) x ({n}, {k}): int32 sums differ '
                                     'from the CPU')
            got = dyn_linear(x, w, scale, bias)
            ref = dyn_linear(x.cpu(), w.cpu(), scale.cpu(), bias.cpu())
            err = check('dyn_linear', got.cpu(), ref, 1e-6, f'({m}, {k}) x ({n}, {k})')
            rerun_identical('dyn_linear', lambda: dyn_linear(x, w, scale, bias), got,
                            f'({m}, {k}) x ({n}, {k})')
            ms = device_ms(lambda: dyn_linear(x, w, scale, bias))
            woq = device_ms(lambda: woq_matmul(x, w, scale, bias))
            lin = device_ms(lambda: torch.nn.functional.linear(x, w16, bias))
            b = bound(nbytes(x, w, scale, bias) + m * n * 2, 2.0 * m * n * k, 'int8')
            line = (f'[dyn] M={m} K={k} N={n}: dyn_linear {ms:.4f} ms, woq_matmul '
                    f'{woq:.4f} ms, F.linear (bf16 weight) {lin:.4f} ms, bound '
                    f'{b["bound_ms"]:.4f} ms ({b["bound_by"]}); int32 sums equal the '
                    f'CPU\'s, max_abs_err {err:.3e}')
            if m < INT_MM_MIN_ROWS:
                padded = torch.zeros((INT_MM_MIN_ROWS, k), dtype=torch.int8, device='cuda')
                padded[:m] = xq
                raw = device_ms(lambda: torch._int_mm(padded, w.t()))
                mm = device_ms(lambda: int8_mm(xq, w))
                line += (f'; int8_mm with its padding to {INT_MM_MIN_ROWS} rows {mm:.4f} ms, '
                         f'_int_mm on rows already padded {raw:.4f} ms')
            log(line)


def dyn_request(torch, dq_model, clip, ladder, default: dict) -> dict:
    """A dq greedy request (kv_quant=4) on ``clip`` (20 s) with
    STABLE_TS_TPU_WOQ=dyn: it must run every quantized linear through
    dyn_linear and launch woq_matmul 0 times. Its ms per decoder step is
    logged beside the default request's (``default``) of the same run.
    Returns its launches."""
    from stable_ts_tpu_torch.models.whisper import quantization
    calls = [0]
    dyn_linear = quantization.dyn_linear

    def counted(*a, **kw):
        calls[0] += 1
        return dyn_linear(*a, **kw)
    quantization.dyn_linear = counted
    os.environ['STABLE_TS_TPU_WOQ'] = 'dyn'
    reqs = []
    try:
        counts = drive_paths(torch, dq_model, [
            ('dq dyn', [('20 s greedy, language=en, kv_quant=4, STABLE_TS_TPU_WOQ=dyn', clip,
                         dict(language='en', temperature=0, kv_quant=4))],
             None, ('flash_attn', 'self_attn_decode', 'cross_attn_decode_int4',
                    'logit_epilogue', 'dtw_cost'))], ladder, reqs)
    finally:
        del os.environ['STABLE_TS_TPU_WOQ']
        quantization.dyn_linear = dyn_linear
    (dyn,) = reqs
    log(f'[dq dyn] {calls[0]} dyn_linear calls, {counts.get("woq_matmul", 0)} woq_matmul '
        f'launches; ms per decoder step or prefill, same run: dyn {dyn["ms_per_step"]:.2f} '
        f'(wall {dyn["wall"]:.3f} s) against the default {default["ms_per_step"]:.2f} '
        f'(wall {default["wall"]:.3f} s)')
    if counts.get('woq_matmul', 0) or not calls[0]:
        raise AssertionError(f'dyn request: {counts.get("woq_matmul", 0)} woq_matmul '
                             f'launches, {calls[0]} dyn_linear calls')
    return counts


def drive_paths(torch, model, paths, ladder, requests_out=None) -> dict:
    """Drive ``paths`` on ``model``: each is (name, requests, options,
    kernels it must launch), a request (label, clip) or (label, clip,
    options). Returns the kernel launches summed over the paths; each
    request's own launches, window count (encoder passes), word-timing
    seconds and word-timing peak device memory over what was resident go
    to ``requests_out`` when given."""
    from stable_ts_tpu_torch import _build
    # host-clock phase split (each phase ends in a device synchronize); the
    # decoder steps are counted at decoding.decoder_step
    import stable_ts_tpu_torch.models.whisper.decoding as decoding
    import stable_ts_tpu_torch.transcribe as driver
    phases, rungs, steps, calls, peak = {}, [], [0], {}, [0]

    def timed(fn, phase):
        def inner(*a, **kw):
            torch.cuda.synchronize()
            if phase == 'word_timing':
                torch.cuda.reset_peak_memory_stats()
                resident = torch.cuda.memory_allocated()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phases[phase] = phases.get(phase, 0.0) + time.perf_counter() - t
            calls[phase] = calls.get(phase, 0) + 1
            if phase == 'word_timing':
                peak[0] = max(peak[0], torch.cuda.max_memory_allocated() - resident)
            if phase == 'decode':
                opts = a[1]
                rungs.append((opts.temperature, opts.best_of, opts.beam_size))
            return out
        return inner

    def counted_step(*a, **kw):
        steps[0] += 1
        return step_fn(*a, **kw)

    step_fn, word_fn = decoding.decoder_step, driver.add_word_timestamps
    decoding.decoder_step = counted_step
    driver.add_word_timestamps = timed(word_fn, 'word_timing')
    model.embed_audio = timed(model.embed_audio, 'encode')
    model.detect_language = timed(model.detect_language, 'detect_language')
    model.decode = timed(model.decode, 'decode')
    counts = {}
    try:
        for path, requests, options, needed in paths:
            _build.reset_launch_counts()
            for label, clip, *request_options in requests:
                opts = request_options[0] if request_options else options
                duration = clip.shape[-1] / SR
                phases.clear()
                rungs.clear()
                calls.clear()
                steps[0] = peak[0] = 0
                before = _build.launch_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                result = model.transcribe(clip, verbose=None, **opts)
                srt = result.to_srt_vtt(word_level=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n_words = check_result(result, srt, duration)
                check_rungs(opts, rungs, result, ladder)
                split = ', '.join(f'{k} {v:.3f} s' for k, v in phases.items())
                log(f'[{path}] request {label}: wall {wall:.3f} s '
                    f'({wall / duration:.4f} s per audio second), language '
                    f'{result.language}, {len(result.segments)} segments, {n_words} '
                    f'words, srt {len(srt)} bytes; {len(rungs)} decode calls '
                    f'{sorted(set(rungs), key=str)}, {steps[0]} decoder steps '
                    f'({phases["decode"] / (steps[0] + len(rungs)) * 1e3:.2f} ms per '
                    f'step or prefill); {split}, other '
                    f'{wall - sum(phases.values()):.3f} s; word-timing peak '
                    f'+{peak[0] / 1e9:.3f} GB over the resident '
                    f'{torch.cuda.memory_allocated() / 1e9:.3f} GB')
                if requests_out is not None:
                    after = _build.launch_counts()
                    requests_out.append(dict(
                        label=label, wall=wall, duration=duration, text=result.text,
                        word_tokens=[list(w.tokens) for w in result.all_words()],
                        windows=calls.get('encode', 0),
                        word_timing_s=phases.get('word_timing', 0.0),
                        word_timing_peak_bytes=peak[0],
                        ms_per_step=phases['decode'] / (steps[0] + len(rungs)) * 1e3,
                        launches={k: after[k] - before.get(k, 0) for k in after}))
            path_counts = _build.launch_counts()
            log(f'[{path}] kernel launches on this path: {path_counts}')
            for name in needed:
                if path_counts.get(name, 0) <= 0:
                    raise AssertionError(f'kernel {name} was not launched on the '
                                         f'{path} path')
            for name, n in path_counts.items():
                counts[name] = counts.get(name, 0) + n
    finally:
        decoding.decoder_step, driver.add_word_timestamps = step_fn, word_fn
    return counts


def align_words_grid(seconds: float, seg_dur: float = 10.0, rate: float = 2.2) -> list:
    """A dense grid of ``seg_dur``-s segments at ``rate`` words a second of
    short synthetic words (``bench.py:main_align_words``): known segment
    boundaries, the timing pass at a production word density."""
    segs, t, i = [], 0.0, 0
    while t < seconds - 1.0:
        end = min(t + seg_dur, seconds)
        n = int((end - t) * rate)
        segs.append(dict(start=round(t, 2), end=round(end, 2),
                         text=' '.join(f'w{(i + j) % 97:02d}' for j in range(n))))
        i += n
        t = end
    return segs


def run_align(torch, path: str, label: str, fn, duration: float, exact=None,
              needed=()):
    """One align request (``fn``) with the launch counts reset before it and
    read after it. Logs its wall, seconds per audio second, launches and
    peak device memory over what was resident; fails unless it gave words
    inside the clip, launched every kernel of ``needed`` and exactly the
    launches of ``exact``. Returns (result, launches, summary)."""
    from stable_ts_tpu_torch import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - resident
    words = result.all_words() if result is not None else []
    log(f'[{path}] request {label}: wall {wall:.3f} s ({wall / duration:.4f} s per '
        f'audio second), {len(result.segments) if result is not None else 0} '
        f'segments, {len(words)} words; launches {launches}; peak +{peak / 1e9:.3f} GB '
        f'over the resident {resident / 1e9:.3f} GB')
    if not words:
        raise AssertionError(f'{path}: no words')
    for w in words:
        if not (math.isfinite(w.start) and math.isfinite(w.end)
                and 0 <= w.start <= w.end <= duration + 0.02):
            raise AssertionError(f'{path}: word {w.word!r} at {w.start}-{w.end} '
                                 f'outside the {duration} s clip')
    for name in needed:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f'kernel {name} was not launched on the {path} path')
    for name, n in (exact or {}).items():
        if launches.get(name, 0) != n:
            raise AssertionError(f'{path}: {launches.get(name, 0)} {name} launches, '
                                 f'expected {n}')
    return result, launches, dict(wall=wall, duration=duration, peak_bytes=peak)


def align_paths(torch, model, audio, greedy_20: dict, segments: list):
    """``model.align`` of the 20-s greedy request's own transcript on its
    clip (the product case: arbitrary text under random weights runs the
    failure ladder instead), beside that request's wall; then
    ``model.align_words`` over a 60-s grid of 10-s segments, with
    ``parallel`` at its default on the card (one encoder and one capture
    pass: 64 flash launches, and one DTW launch for every segment) and
    with ``parallel=False`` (64 flash launches and one DTW a segment),
    which must give the same words in the same order. Returns the
    launches summed over the requests and the parallel ``align_words``
    result."""
    counts = {}

    def add(launches):
        for name, n in launches.items():
            counts[name] = counts.get(name, 0) + n

    text = greedy_20['text']
    if not text.strip():
        raise AssertionError('align: the 20-s greedy request transcribed no text')
    clip = audio[75 * SR:95 * SR]
    _, launches, summary = run_align(
        torch, 'align', f'20 s, the greedy transcript ({len(text)} characters)',
        lambda: model.align(clip, text, language='en', verbose=None), 20.0,
        needed=('flash_attn', 'dtw_cost'))
    add(launches)
    log(f'[align] seconds per audio second, same run: align 20 s '
        f'{summary["wall"] / 20.0:.4f} (wall {summary["wall"]:.3f} s) against greedy '
        f'transcribe {greedy_20["label"]} {greedy_20["wall"] / greedy_20["duration"]:.4f} '
        f'(wall {greedy_20["wall"]:.3f} s): '
        f'{greedy_20["wall"] / summary["wall"]:.2f}x')

    clip = audio[:60 * SR]
    n_seg = len(segments)
    passes = model.dims.n_audio_layer + model.dims.n_text_layer   # 64 at large-v3
    results = {}
    for parallel, exact in ((None, {'flash_attn': passes, 'dtw_cost': 1}),
                            (False, {'flash_attn': passes * n_seg, 'dtw_cost': n_seg})):
        kw = {} if parallel is None else dict(parallel=parallel)
        label = (f'60 s, {n_seg} segments of 10 s, '
                 + ('parallel (the default)' if parallel is None else 'parallel=False'))
        results[parallel], launches, _ = run_align(
            torch, 'align_words', label,
            lambda: model.align_words(clip, [dict(s) for s in segments],
                                      language='en', verbose=None, **kw),
            60.0, exact=exact)
        add(launches)
    par, seq = (results[None].all_words(), results[False].all_words())
    if [w.word for w in par] != [w.word for w in seq]:
        raise AssertionError('align_words: parallel and sequential words differ')
    diff = max(max(abs(a.start - b.start), abs(a.end - b.end)) for a, b in zip(par, seq))
    log(f'[align_words] parallel against parallel=False: {len(par)} words equal, '
        f'largest start or end difference {diff:.3f} s')
    return counts, results[None]


def refine_paths(torch, models: dict, audio, batched_greedy: dict) -> dict:
    """``model.refine`` of the batched greedy 300-s result on its clip, on
    each of ``models`` (the bf16 weights and an f32 copy), with
    ``parallel`` at its default on the card (lockstep rounds in two span
    groups, interval mode: the rows rebuilt on the card from each span's
    audio and its mute intervals) and with ``parallel=False`` (one probe a
    span at a time, the full softmax downloaded). ``prob_threshold=0.0``:
    random weights give every word a probability far below the default
    0.5, which would end every span at its baseline probe, so no round
    would run. The parallel requests must run interval rounds in two span
    groups with several spans in a round; both must launch flash and give
    the same words. In f32 they must give the same word times: a round's
    batch shape changes bf16 rounding (cuBLAS picks its kernels by shape),
    and random weights leave many bisection decisions within that rounding
    of their 3 % thresholds, so in bf16 the differing times are logged, not
    gated. :func:`probe_spread` logs, for the round with the most spans,
    how far each span's probabilities move between that round, the span
    alone and the sequential probe. Returns the launches summed over the
    requests."""
    from stable_ts_tpu_torch import alignment
    from stable_ts_tpu_torch.non_whisper.refinement import MutedSpanProbe
    counts = {}
    calls = {}
    widest = []
    batch_func, probe_func = (alignment._whisper_refinement_batch_func,
                              alignment._whisper_refinement_func)

    def batch_spy(*a):
        fn = batch_func(*a)
        launch = fn.launch

        def counted(requests, key=0):
            calls['rounds'] = calls.get('rounds', 0) + 1
            calls.setdefault('keys', set()).add(key)
            if isinstance(requests[0][0], MutedSpanProbe):
                calls['interval rounds'] = calls.get('interval rounds', 0) + 1
            calls['spans'] = calls.get('spans', 0) + len(requests)
            if len(requests) > calls.get('most spans a round', 0):
                calls['most spans a round'] = len(requests)
                widest[:] = list(requests)
            return launch(requests, key)
        fn.launch = counted
        return fn

    def probe_spy(*a):
        fn = probe_func(*a)

        def counted(*b):
            calls['probes'] = calls.get('probes', 0) + 1
            return fn(*b)
        return counted

    source = batched_greedy['result']
    duration = batched_greedy['duration']
    clip = audio[:round(duration * SR)]
    rate = batched_greedy['s_per_audio_s']
    before = [(w.start, w.end) for w in source.all_words()]
    alignment._whisper_refinement_batch_func = batch_spy
    alignment._whisper_refinement_func = probe_spy
    try:
        for tag, model in models.items():
            results = {}
            for parallel in (None, False):
                calls.clear()
                kw = {} if parallel is None else dict(parallel=parallel)
                label = (f'{tag}, {duration:.0f} s, the batched greedy result, '
                         'prob_threshold=0.0, '
                         + ('parallel (the default)' if parallel is None
                            else 'parallel=False'))
                results[parallel], launches, summary = run_align(
                    torch, 'refine', label,
                    lambda: model.refine(clip, source, inplace=False, prob_threshold=0.0,
                                         verbose=None, **kw),
                    duration, needed=('flash_attn',))
                for name, n in launches.items():
                    counts[name] = counts.get(name, 0) + n
                moved = sum(b != (w.start, w.end)
                            for b, w in zip(before, results[parallel].all_words()))
                log(f'[refine] {label}: {dict(calls)}; {moved} of {len(before)} word '
                    f'times moved; seconds per audio second '
                    f'{summary["wall"] / duration:.4f} against the batched greedy '
                    f'transcribe of the clip (bf16) {rate:.4f}')
                if parallel is None:
                    if (calls.get('keys') != {0, 1}
                            or calls.get('interval rounds') != calls['rounds']
                            or calls['most spans a round'] < 2):
                        raise AssertionError(f'refine: expected interval rounds in two '
                                             f'span groups, several spans a round, got '
                                             f'{dict(calls)}')
                    probe_spread(torch, model, batch_func, probe_func, source.language,
                                 widest, tag)
            par, seq = results[None].all_words(), results[False].all_words()
            if [w.word for w in par] != [w.word for w in seq]:
                raise AssertionError(f'refine {tag}: parallel and sequential words differ')
            diff = max(max(abs(a.start - b.start), abs(a.end - b.end))
                       for a, b in zip(par, seq))
            n_diff = sum((a.start, a.end) != (b.start, b.end) for a, b in zip(par, seq))
            log(f'[refine] {tag} parallel against parallel=False: {len(par)} words equal, '
                f'{n_diff} word times differ, largest start or end difference {diff:.3f} s')
            if tag == 'f32' and n_diff:
                raise AssertionError(f'refine f32: {n_diff} word times differ between '
                                     f'parallel and parallel=False')
    finally:
        alignment._whisper_refinement_batch_func = batch_func
        alignment._whisper_refinement_func = probe_func
    return counts


def probe_spread(torch, model, batch_func, probe_func, language, requests, tag) -> None:
    """One refine round's ``requests`` (MutedSpanProbe, tokens) three ways:
    batched as the round ran, each span alone through the batch function,
    and each span's muted rows through the sequential probe (its full
    softmax, read at the realized tokens). Logs the largest relative
    difference of the realized tokens' probabilities between them and how
    many of their ranks differ."""
    import numpy as np
    tokenizer = model.get_tokenizer(language=language, task='transcribe')
    fn = batch_func(model, tokenizer)
    probe = probe_func(model, tokenizer)
    full = fn.collect(fn.launch(requests, key=0))
    worst = {'alone': 0.0, 'sequential': 0.0}
    ranks_differ = 0
    for i, ((p, tokens), (probs, ranks)) in enumerate(zip(requests, full)):
        alone, alone_ranks = fn.collect(fn.launch([(p, tokens)], key=1 + i))[0]
        rows = np.repeat(p.clean[None], 2, axis=0)
        for r, a, b in zip(p.rows, p.zero_lo, p.zero_hi):
            rows[r, a:b] = 0
        soft = probe(rows, tokens)
        seq = soft[:, np.arange(len(tokens)), np.asarray(tokens)]
        for name, other in (('alone', alone), ('sequential', seq)):
            worst[name] = max(worst[name], float(np.max(np.abs(probs - other) / other)))
        ranks_differ += int(np.sum(ranks != alone_ranks))
    log(f'[refine] {tag} round of {len(requests)} spans: realized-token probabilities '
        f'against each span alone, largest relative difference {worst["alone"]:.3e}; '
        f'against the sequential probe {worst["sequential"]:.3e}; ranks differing from '
        f'the span alone: {ranks_differ}')


def run_locate(torch, path: str, label: str, fn, needed, greedy_rate: float,
               expect_match: bool = True):
    """One locate request (``fn``) on the 75-s clip with the launch counts
    reset before it and read after it. Logs its wall and seconds per audio
    second beside the greedy request's (``greedy_rate``), its matches,
    launches and peak device memory over what was resident; fails unless it
    found a match (none, with ``expect_match=False``) and launched every
    kernel of ``needed``. Returns (matches, launches)."""
    from stable_ts_tpu_torch import _build
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    found = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - resident
    log(f'[{path}] request {label}: wall {wall:.3f} s ({wall / 75.0:.4f} s per audio '
        f'second; greedy transcribe of the clip {greedy_rate:.4f}, '
        f'{greedy_rate * 75.0 / wall:.2f}x), {len(found)} matches '
        f'{describe_matches(found)}; launches {launches}; peak +{peak / 1e9:.3f} GB '
        f'over the resident {resident / 1e9:.3f} GB')
    if bool(found) != expect_match:
        raise AssertionError(f'{path} {label}: {len(found)} matches, expected '
                             + ('some' if expect_match else 'none'))
    for name in needed:
        if launches.get(name, 0) <= 0:
            raise AssertionError(f'kernel {name} was not launched on the {path} '
                                 f'{label} path')
    return found, launches


LOCATE_DECODE = ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'vocab_proj')


def locate_word(greedy_75: dict) -> list:
    """The target of locate: the first 4 token ids of the greedy 75-s
    transcript's token stream (its words' tokens in order), so that the
    confirmation decode forces several tokens. A confirmation decode ends
    after ``max_token_per_seg`` = 20 tokens."""
    stream = [t for tokens in greedy_75['word_tokens'] for t in tokens]
    if len(stream) < 4:
        raise AssertionError(f'locate: the 75-s greedy request transcribed '
                             f'{len(stream)} tokens')
    return stream[:4]


def locate_paths(torch, model, audio, greedy_75: dict) -> dict:
    """``model.locate`` of the start of the greedy 75-s transcript
    (:func:`locate_word`) in its clip: mode 2 (the end estimate alone, the
    default threshold), then modes 1 and 0 with ``probability_threshold=0.0``,
    so that on random weights the confirmation decode forces the 4 target
    tokens and mode 0's timing pass runs; mode 1 must launch the self and
    cross decode entries and ``vocab_proj``, mode 0 also the DTW. Then a
    rollback request: mode 1 on the first 3 of those tokens and a
    suppressed one, at ``probability_threshold=1e-30``. Random weights
    give every unsuppressed token a probability far above that and a
    suppressed one exactly 0, so the decode forces the 3 tokens, rejects
    the fourth, puts its own choices back and re-prefills, and no chunk
    matches: it must make more prefills than confirmation decodes. Returns
    the launches summed over the requests."""
    import stable_ts_tpu_torch.models.whisper.model as model_mod
    from stable_ts_tpu_torch.models.whisper.decoding import (DecodingOptions,
                                                             build_suppress_list)
    counts = {}
    word = locate_word(greedy_75)
    tokenizer = model.get_tokenizer(language='en', task='transcribe')
    suppressed = min(i for i in build_suppress_list(tokenizer, DecodingOptions(
        language='en', suppress_tokens='-1', without_timestamps=True))
        if i < tokenizer.eot)
    rollback = word[:3] + [suppressed]
    clip = audio[:75 * SR]
    greedy_rate = greedy_75['wall'] / greedy_75['duration']
    calls = {}

    def counted(name, fn):
        def inner(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return inner

    prefill, cross_kv = model_mod.decoder_prefill, model_mod.precompute_cross_kv_t
    model_mod.decoder_prefill = counted('prefills', prefill)
    model_mod.precompute_cross_kv_t = counted('confirmations', cross_kv)
    try:
        for label, target, kw, needed, expect in (
                ('mode 2', word, dict(mode=2), ('flash_attn',), True),
                ('mode 1', word, dict(mode=1, probability_threshold=0.0),
                 LOCATE_DECODE, True),
                ('mode 0', word, dict(mode=0, probability_threshold=0.0),
                 LOCATE_DECODE + ('dtw_cost',), True),
                ('mode 1 rollback', rollback, dict(mode=1, probability_threshold=1e-30),
                 LOCATE_DECODE, False)):
            calls.clear()
            _, launches = run_locate(
                torch, 'locate', f'{label}, tokens {target} in 75 s',
                lambda: model.locate(clip, target, language='en', verbose=None, **kw),
                needed, greedy_rate, expect_match=expect)
            log(f'[locate] {label}: {dict(calls)}')
            for name, n in launches.items():
                counts[name] = counts.get(name, 0) + n
    finally:
        model_mod.decoder_prefill, model_mod.precompute_cross_kv_t = prefill, cross_kv
    if not calls.get('prefills', 0) > calls.get('confirmations', 0) > 0:
        raise AssertionError(f'locate rollback: {dict(calls)}, expected more prefills '
                             f'than confirmation decodes')
    return counts


def describe_matches(found) -> list:
    """A locate result's matches, short: the end of each (modes 2 and 1) or
    its words' start and end (mode 0)."""
    out = []
    for m in found:
        if isinstance(m, dict):
            out.append(dict(end=m.get('target_end', m.get('end')),
                            tokens=len(m.get('tokens', [])) or sum(
                                len(w['tokens']) for w in m.get('duration_window_word', []))))
        else:
            out.append([(w.word, w.start, w.end) for w in m.words])
    return out


def batched_paths(torch, requests, summaries: dict) -> dict:
    """Drive each request (name, model, clip, options, kernels it must
    launch) through ``model.transcribe_batched`` once, with the launch
    counts reset before it and read after it; a warning that the batch was
    halved or capped is an error (a smaller batch is not the path the
    request names). Logs wall seconds, seconds per audio second, window
    groups, decoder steps, ms a step (the decode calls' time on the main
    stream over their steps), rows and real windows a step, the
    decode calls (temperature, best_of, beam, rows), HOST_PHASES and the
    peak device memory over what was resident before the request. Checks
    per request: the kernels launched; 'batched greedy' two groups of 64
    flash launches (32 encoder layers + 32 capture-pass layers) and one DTW
    launch each; 'batched ladder' one encode for its one group whatever the
    rungs, and the group entry and vocab_proj on a rung above 0 if any
    window fell back; 'batched no heads' two DTW launches a group ('6,2':
    one refinement pass). Returns the launches summed; each request's
    numbers go to ``summaries``."""
    import warnings
    import numpy as np
    import stable_ts_tpu_torch.batched as batched_mod
    import stable_ts_tpu_torch.models.whisper.decoding as decoding
    from stable_ts_tpu_torch import _build
    counts = {}
    step_fn = decoding.decoder_step
    step_rows = []

    def counted_step(decoder, tokens, *a, **kw):
        step_rows.append(tokens.shape[0])
        return step_fn(decoder, tokens, *a, **kw)

    decoding.decoder_step = counted_step
    try:
        for name, model, clip, options, needed in requests:
            duration = clip.shape[-1] / SR
            calls, encodes, decode_s, first_rung = [], [0], [0.0], [0]
            stream = torch.cuda.current_stream()
            real = {k: getattr(model, k) for k in ('embed_audio', 'decode_launch', 'decode')}

            def embed(mel, _f=real['embed_audio']):
                encodes[0] += 1
                return _f(mel)

            def timed_decode(kind):
                def inner(feats, options, **kw):
                    # the main stream only: the side stream's timing pass
                    # runs on meanwhile
                    stream.synchronize()
                    t = time.perf_counter()
                    out = real[kind](feats, options, **kw)
                    stream.synchronize()
                    decode_s[0] += time.perf_counter() - t
                    calls.append((options.temperature, options.best_of, options.beam_size,
                                  int(feats.shape[0])))
                    if kind == 'decode_launch':
                        first_rung[0] += 1
                    return out
                return inner

            model.embed_audio = embed
            model.decode_launch = timed_decode('decode_launch')
            model.decode = timed_decode('decode')
            step_rows.clear()
            batched_mod.HOST_PHASES.clear()
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            try:
                with warnings.catch_warnings():
                    warnings.filterwarnings('error', message='.*retrying transcription.*')
                    warnings.filterwarnings('error', message='.*device memory capacity.*')
                    result = model.transcribe_batched(clip, verbose=None, **options)
                    srt = result.to_srt_vtt(word_level=True)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                for k in real:
                    delattr(model, k)
            peak = torch.cuda.max_memory_allocated() - resident
            launches = _build.launch_counts()
            n_words = check_result(result, srt, duration)
            groups = encodes[0]
            windows = int(np.ceil(duration / 30))
            steps = len(step_rows)
            hp = ', '.join(f'{k} {v:.3f} s' for k, v in batched_mod.HOST_PHASES.items())
            summaries[name] = dict(wall=wall, duration=duration,
                                   s_per_audio_s=wall / duration, groups=groups,
                                   steps=steps, launches=launches, peak=peak,
                                   result=result)
            log(f'[{name}] {duration:.0f} s, {options}: wall {wall:.3f} s ({wall / duration:.4f} '
                f's per audio second), language {result.language}, {len(result.segments)} '
                f'segments, {n_words} words, srt {len(srt)} bytes; {groups} groups of '
                f'{options["batch_size"]} windows, {steps} decoder steps, decode '
                f'{decode_s[0]:.3f} s ({decode_s[0] / max(steps + len(calls), 1) * 1e3:.2f} ms '
                f'per step or prefill), {np.mean(step_rows) if step_rows else 0:.1f} rows a '
                f'step, {windows / max(first_rung[0], 1):.2f} real windows a first-rung step; '
                f'decode calls (temperature, best_of, beam, rows) {calls}; HOST_PHASES {hp}; '
                f'peak +{peak / 1e9:.3f} GB over the resident {resident / 1e9:.3f} GB')
            log(f'[{name}] kernel launches: {launches}')
            missing = [k for k in needed if launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f'{name}: kernels not launched: {missing}')
            if name == 'batched greedy':
                want = dict(flash_attn=64 * groups, dtw_cost=groups)
                got = {k: launches.get(k, 0) for k in want}
                if groups != 2 or got != want:
                    raise AssertionError(f'{name}: {groups} groups, launches {got}, want '
                                         f'2 groups and {want}')
                log(f'[{name}] one encode and one timing pass a group: {groups} groups, '
                    f'{got["flash_attn"]} flash launches (32 encoder + 32 capture pass a '
                    f'group), {got["dtw_cost"]} DTW launches')
            elif name == 'batched ladder':
                rungs = sorted({c[0] for c in calls})
                retries = [c for c in calls if c[0] > 0]
                log(f'[{name}] rungs {rungs}; retry rows {[c[3] for c in retries]} '
                    f'(x best_of {options["best_of"]}); encoder runs {groups}, flash '
                    f'launches {launches.get("flash_attn", 0)}')
                if groups != 1 or launches.get('flash_attn', 0) != 64:
                    raise AssertionError(f'{name}: the encoder ran {groups} times '
                                         f'({launches.get("flash_attn", 0)} flash launches) '
                                         'for one group')
                if retries:
                    for k in ('cross_attn_decode_group', 'vocab_proj'):
                        if launches.get(k, 0) <= 0:
                            raise AssertionError(f'{name}: a rung above 0 launched no {k}')
                else:
                    log(f'[{name}] no window fell back: every window stood at temperature 0')
            elif name == 'batched no heads':
                if launches.get('dtw_cost', 0) != 2 * groups:
                    raise AssertionError(f'{name}: {launches.get("dtw_cost", 0)} DTW launches '
                                         f'for {groups} groups, want two a group')
            elif name == 'batched beam':
                log(f'[{name}] detected language: {result.language}')
            for k, n in launches.items():
                counts[k] = counts.get(k, 0) + n
    finally:
        decoding.decoder_step = step_fn
    return counts


def decode_busy_share(torch, model, audio) -> None:
    """Where a decode step's time goes at 1 row and at 8: the greedy decode
    of one window and of 8 windows (features of the first 240 s of
    ``audio``), 32 steps at most, each once under torch.profiler after a
    warm-up call: wall a step, the device's busy share of the wall (the
    kernels' durations summed) and the top kernels."""
    import numpy as np
    import stable_ts_tpu_torch.models.whisper.decoding as decoding
    from stable_ts_tpu_torch.constants import N_FRAMES, N_SAMPLES
    from stable_ts_tpu_torch.ops.mel import log_mel_spectrogram
    wins = np.stack([audio[i * N_SAMPLES:(i + 1) * N_SAMPLES] for i in range(8)])
    mels = log_mel_spectrogram(wins, model.dims.n_mels, device='cuda')[..., :N_FRAMES]
    feats = model.embed_audio(mels)
    options = decoding.DecodingOptions(language='en', temperature=0, sample_len=32)
    step_fn, steps = decoding.decoder_step, [0]

    def counted(*a, **kw):
        steps[0] += 1
        return step_fn(*a, **kw)

    decoding.decoder_step = counted
    try:
        for rows in (1, 8):
            model.decode(feats[:rows], options)
            steps[0] = 0
            _, wall, busy, _, top = profiled(lambda: model.decode(feats[:rows], options))
            log(f'[decode profile] greedy, {rows} row(s), {steps[0]} steps under '
                f'torch.profiler: wall {wall * 1e3 / max(steps[0], 1):.2f} ms a step, device '
                f'busy {busy * 1e3 / max(steps[0], 1):.3f} ms a step ({busy / wall:.1%} of the '
                f'wall); top kernels (name, calls, ms) {top}')
    finally:
        decoding.decoder_step = step_fn


def check_rungs(options: dict, rungs: list, result, ladder: tuple) -> None:
    """The decode calls each request made: a request at temperature 0
    decodes each window once, with its beam size; the ladder, with random
    weights whose avg_logprob is far below -1, runs every rung of every
    window in order, best_of only above 0, and the segments keep the last
    rung."""
    if options['temperature'] == ladder:
        want = [(t, 5 if t > 0 else None, None) for t in ladder]
        if not rungs or rungs != want * (len(rungs) // len(want)):
            raise AssertionError(f'ladder rungs {rungs}, expected repeats of {want}')
        temps = {s.temperature for s in result.segments}
        if temps != {ladder[-1]}:
            raise AssertionError(f'segment temperatures {temps} != {{{ladder[-1]}}}')
    else:
        beam = options.get('beam_size')
        if set(rungs) != {(0, None, beam)}:
            raise AssertionError(f'decode calls {set(rungs)}, expected '
                                 f'{{(0, None, {beam})}}')


# -- the multi-GPU layer: kernels at the tp shard shapes, a world of one over
# NCCL, two ranks on the one card over gloo --------------------------------------------

def shard_kernel_checks(torch, results: dict, randn, gen) -> None:
    """Every kernel that runs on a tp shard, at the shard's shapes for
    tp = 2 and tp = 4 (large-v3's 20 heads of 64: 10 or 5 heads, d = 640
    or 320): flash over the batched encoder (8,1500,d) and the capture pass
    (8,256,d) x 1500; the self entry at 8 rows of an (8,256,d) int8 cache;
    the cross entry at 8 rows and the group entry over 4 windows x 5 beams
    of int8 K/V; the beam self entry at 20 rows; the int4 entries at 2 rows
    and g = 5; woq_matmul at M = 8 (a batched decode step) and 12000 (eight
    windows' encoder) for each sharded linear, (N, K) = (3d, 1280) the
    fused qkv, (1280, d) out, (4d, 1280) fc1, (1280, 4d) fc2. Each within
    its twin's tolerance at the full shapes, with its device time, its
    twin's, its bound and, for flash, SDPA's; the numbers go under
    "shards" in each kernel's entry, keyed "tp=2 ..." and "tp=4 ..."."""
    import torch.nn.functional as F
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.models.whisper.quantization import quantize_weight
    from stable_ts_tpu_torch.ops import cross_attn, flash_attn, self_attn
    from stable_ts_tpu_torch.ops import woq_matmul as woq
    s, ctx, pos, layers, dh = 1500, 256, 200, 8, 64

    def put(name, key, numbers):
        results[name].setdefault('shards', {})[key] = numbers

    for tp in (2, 4):
        h = 20 // tp
        d = h * dh
        scale = dh ** -0.5
        for b, t, what in ((8, 1500, f'encoder bf16 (8,1500,{d}), {h} heads'),
                           (8, 256, f'capture pass bf16 (8,256,{d})x1500, {h} heads')):
            q = randn(b, t, d, dtype=torch.bfloat16)
            k, v = randn(b, s, d, dtype=torch.bfloat16), randn(b, s, d, dtype=torch.bfloat16)
            got = flash_attn.flash_attention(q, k, v, h, scale)
            ref = flash_attn.flash_attention_ref(q, k, v, h, scale)
            torch.cuda.synchronize()
            err = check('flash_attn', got, ref, 2e-2, f'tp={tp} {what}')
            qh, kh, vh = (a.view(b, -1, h, dh).transpose(1, 2) for a in (q, k, v))
            ms, plain, lib = (device_ms(fn, iters=10) for fn in (
                lambda: flash_attn.flash_attention(q, k, v, h, scale),
                lambda: flash_attn.flash_attention_ref(q, k, v, h, scale),
                lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)))
            numbers = entry(err, ms, plain, nbytes(q, k, v, q), 4 * b * t * s * d, 'bf16',
                            lib)
            log(f'[kernel] flash_attn tp={tp} {what}: device kernel {ms:.4f} ms, twin '
                f'{plain:.4f} ms, scaled_dot_product_attention {lib:.4f} ms; bound '
                f'{numbers["bound_ms"]:.4f} ms ({numbers["bound_by"]})')
            put('flash_attn', f'tp={tp} {what}', numbers)
            del q, k, v, got, ref

        rows = 8
        kc, ks = quantize_rows(randn(rows, ctx, d))
        vc, vs = quantize_rows(randn(rows, ctx, d))
        q = randn(rows, d) * scale
        args = (q, kc, vc, ks, vs, pos, h)
        what = f'int8 cache (8,256,{d}) pos 200, 8 rows, {h} heads'
        got = self_attn.self_attn_decode(*args)
        ref = self_attn.self_attn_decode_ref(*args)
        torch.cuda.synchronize()
        err = check('self_attn_decode', got, ref, 1e-4, f'tp={tp} {what}')
        ms = device_ms(lambda: self_attn.self_attn_decode(*args), iters=200)
        plain = device_ms(lambda: self_attn.self_attn_decode_ref(*args), iters=200)
        numbers = entry(err, ms, plain, 2 * rows * (pos + 1) * (d + 4) + nbytes(q, got),
                        4 * rows * (pos + 1) * d, 'f32')
        log(f'[kernel] self_attn_decode tp={tp} {what}: device kernel {ms:.4f} ms, twin '
            f'{plain:.4f} ms, bound {numbers["bound_ms"]:.5f} ms')
        put('self_attn_decode', f'tp={tp} {what}', numbers)

        for windows, g, name in ((8, 1, 'cross_attn_decode'),
                                 (4, 5, 'cross_attn_decode_group')):
            kv, sc = quantize_rows(randn(layers, windows, 2, s, d))
            q = randn(windows * g, d) * scale
            args = (q, kv, sc, 7, s, h)
            ref_args = (q, kv[7, :, 0], kv[7, :, 1], sc[7, :, 0], sc[7, :, 1], s, h, g)
            what = f'g={g} int8 kv ({layers},{windows},2,1500,{d}), {windows * g} rows, {h} heads'
            got = cross_attn.cross_attn_decode(*args, q_per_kv=g)
            ref = cross_attn.cross_attn_decode_ref(*ref_args)
            torch.cuda.synchronize()
            err = check(name, got, ref, 1e-3, f'tp={tp} {what}')
            ms = device_ms(lambda: cross_attn.cross_attn_decode(*args, q_per_kv=g), iters=200)
            plain = device_ms(lambda: cross_attn.cross_attn_decode_ref(*ref_args), iters=50)
            numbers = entry(err, ms, plain, nbytes(kv[7], sc[7], q, got),
                            4 * windows * g * s * d, 'bf16')
            log(f'[kernel] {name} tp={tp} {what}: device kernel {ms:.4f} ms, twin '
                f'{plain:.4f} ms, bound {numbers["bound_ms"]:.5f} ms')
            put(name, f'tp={tp} {what}', numbers)
            del kv, sc

        rows, g = 20, 5
        kc, ks = quantize_rows(randn(rows, ctx, d))
        vc, vs = quantize_rows(randn(rows, ctx, d))
        anc = torch.randint(0, g, (rows, ctx), generator=gen, device='cuda',
                            dtype=torch.int32)
        anc[:, pos] = torch.arange(rows, device='cuda', dtype=torch.int32) % g
        q = randn(rows, d) * scale
        args = (q, kc, vc, ks, vs, pos, h)
        what = f'int8 cache (20,256,{d}) pos 200, 4 windows x 5 beams, {h} heads'
        got = self_attn.self_attn_decode(*args, anc=anc, q_per_kv=g)
        ref = self_attn.self_attn_decode_ref(*args, anc=anc, q_per_kv=g)
        torch.cuda.synchronize()
        err = check('self_attn_decode_beam', got, ref, 1e-4, f'tp={tp} {what}')
        ms = device_ms(lambda: self_attn.self_attn_decode(*args, anc=anc, q_per_kv=g),
                       iters=200)
        plain = device_ms(lambda: self_attn.self_attn_decode_ref(*args, anc=anc, q_per_kv=g),
                          iters=50)
        reached = sum(len(set((anc[w * g:(w + 1) * g, j] + w * g).tolist()))
                      for w in range(rows // g) for j in range(pos + 1))
        numbers = entry(err, ms, plain, 2 * reached * (d + 4) + nbytes(anc[:, :pos + 1], q, got),
                        4 * rows * (pos + 1) * d, 'f32')
        log(f'[kernel] self_attn_decode_beam tp={tp} {what}: device kernel {ms:.4f} ms, twin '
            f'{plain:.4f} ms, bound {numbers["bound_ms"]:.5f} ms')
        put('self_attn_decode_beam', f'tp={tp} {what}', numbers)

        for windows, g, name in ((2, 1, 'cross_attn_decode_int4'),
                                 (1, 5, 'cross_attn_decode_group_int4')):
            vals, sc = quantize_rows(randn(layers, windows, 2, s, d), bits=4)
            kv = cross_attn.pack_int4(vals)
            q = randn(windows * g, d) * scale
            args = (q, kv, sc, 7, s, h)
            ref_args = (q, vals[7, :, 0], vals[7, :, 1], sc[7, :, 0], sc[7, :, 1], s, h, g)
            what = (f'g={g} int4 kv ({layers},{windows},2,1500,{d}) packed, '
                    f'{windows * g} rows, {h} heads')
            got = cross_attn.cross_attn_decode(*args, q_per_kv=g, bits=4)
            ref = cross_attn.cross_attn_decode_ref(*ref_args)
            torch.cuda.synchronize()
            err = check(name, got, ref, 1e-3, f'tp={tp} {what}')
            ms = device_ms(lambda: cross_attn.cross_attn_decode(*args, q_per_kv=g, bits=4),
                           iters=200)
            plain = device_ms(lambda: cross_attn.cross_attn_decode_ref(*ref_args), iters=50)
            numbers = entry(err, ms, plain, nbytes(kv[7], sc[7], q, got),
                            4 * windows * g * s * d, 'bf16')
            log(f'[kernel] {name} tp={tp} {what}: device kernel {ms:.4f} ms, twin '
                f'{plain:.4f} ms, bound {numbers["bound_ms"]:.5f} ms')
            put(name, f'tp={tp} {what}', numbers)

        for n, k, lin in ((3 * d, 1280, 'fused qkv'), (1280, d, 'out'),
                          (4 * d, 1280, 'fc1'), (1280, 4 * d, 'fc2')):
            qw, wscale = quantize_weight(randn(n, k) * 0.02)
            for m in (8, 12000):
                x = randn(m, k, dtype=torch.bfloat16)
                got = woq._woq_cuda(x, qw, wscale)
                ref = woq.woq_matmul_ref(x, qw, wscale)
                torch.cuda.synchronize()
                what = f'{lin} M={m} (K,N)=({k},{n}) bf16 x'
                err = check('woq_matmul', got, ref, 1e-5, f'tp={tp} {what}')
                iters = 200 if m <= 8 else 20
                ms = device_ms(lambda: woq._woq_cuda(x, qw, wscale), iters=iters)
                plain = device_ms(lambda: woq.woq_matmul_ref(x, qw, wscale), iters=iters)
                numbers = entry(err, ms, plain, nbytes(x, qw, wscale, got), 2 * m * n * k,
                                'bf16')
                log(f'[kernel] woq_matmul tp={tp} {what}: device kernel {ms:.4f} ms, twin '
                    f'{plain:.4f} ms, bound {numbers["bound_ms"]:.4f} ms '
                    f'({numbers["bound_by"]})')
                put('woq_matmul', f'tp={tp} {what}', numbers)


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def _same_words(label: str, got, ref) -> None:
    """Fail unless two results have the same text, words, word times,
    probabilities and word-level SRT bytes."""
    gw, rw = got.all_words(), ref.all_words()
    same = (got.text == ref.text and len(gw) == len(rw)
            and all((a.word, a.start, a.end, a.probability)
                    == (b.word, b.start, b.end, b.probability) for a, b in zip(gw, rw))
            and got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True))
    if not same:
        raise AssertionError(f'{label}: the result differs from the unsharded one')


def mesh_one(torch, dims, ranks, heads, model, audio, long_audio, batched_reqs,
             aligned_60, segments) -> dict:
    """A world of one rank over NCCL on the card (``init_process_group``
    at world size 1) and a large-v3 bf16 model (seed 0, the weights of
    ``model``) sharded on its (dp 1, tp 1) mesh: the batched greedy 300 s,
    the 60-s ``align_words`` and a refine of its result, each with the
    launch counts reset and read, each bit for bit the unsharded run's in
    this process. The mesh branches run (the batch split and gathers, the
    decode's out-of-memory agreement over NCCL); a tp group of one rank
    reduces nothing, as a reduction over one rank is the identity. Walls
    are logged beside the unsharded ones. Returns the launches and the
    mesh; the group stays up for :func:`mesh_one_dq_and_train`."""
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper.model import init_params
    from stable_ts_tpu_torch.parallel import build_mesh, distributed_init
    distributed_init(f'127.0.0.1:{_free_port()}', 1, 0, backend='nccl')
    mesh = build_mesh(tp=1, devices='cuda')
    log(f'[mesh one] world of 1 over NCCL: {mesh}')
    sharded = WhisperTorch(dims, init_params(dims, seed=0, dtype=torch.bfloat16,
                                             device='cuda'),
                           device='cuda', name=MODEL + '-mesh', ranks=ranks,
                           alignment_heads=heads).shard(mesh)
    counts, reqs = {}, {}
    needed = ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue',
              'dtw_cost')
    for name, n in batched_paths(torch, [(
            'mesh one batched greedy', sharded, long_audio,
            dict(batch_size=8, language='en', temperature=0), needed)], reqs).items():
        counts[name] = counts.get(name, 0) + n
    ref = batched_reqs['batched greedy']
    _same_words('mesh one batched greedy', reqs['mesh one batched greedy']['result'],
                ref['result'])
    log(f'[mesh one] batched greedy 300 s: bit for bit the unsharded result; wall '
        f'{reqs["mesh one batched greedy"]["wall"]:.3f} s sharded against '
        f'{ref["wall"]:.3f} s unsharded')
    clip = audio[:60 * SR]
    got, launches, summary = run_align(
        torch, 'mesh one align_words', f'60 s, {len(segments)} segments, parallel',
        lambda: sharded.align_words(clip, [dict(s) for s in segments], language='en',
                                    verbose=None),
        60.0, exact={'flash_attn': 64, 'dtw_cost': 1})
    _same_words('mesh one align_words', got, aligned_60)
    for name, n in launches.items():
        counts[name] = counts.get(name, 0) + n
    walls = {}
    for label, m in (('unsharded', model), ('sharded', sharded)):
        res, launches, summary = run_align(
            torch, f'mesh one refine ({label})', '60 s, the align_words result, '
            'prob_threshold=0.0', lambda: m.refine(clip, aligned_60, inplace=False,
                                                   prob_threshold=0.0, verbose=None),
            60.0, needed=('flash_attn',))
        walls[label] = (res, summary['wall'])
        if label == 'sharded':
            for name, n in launches.items():
                counts[name] = counts.get(name, 0) + n
    _same_words('mesh one refine', walls['sharded'][0], walls['unsharded'][0])
    log(f'[mesh one] align_words and refine: bit for bit the unsharded results; refine '
        f'wall {walls["sharded"][1]:.3f} s sharded against {walls["unsharded"][1]:.3f} s')
    del sharded
    return counts, mesh


def mesh_one_dq_and_train(torch, dims, ranks, heads, mesh, long_audio,
                          batched_reqs, audio) -> dict:
    """On the world of one: the batched dq request (int8 weights quantized
    on the card, int4 cross K/V) on a freshly quantized sharded model,
    bit for bit the unsharded 'batched dq'; then two train steps (batch 2
    windows, 64 tokens) on a sharded and on an unsharded fresh bf16
    model, the same losses and weights bit for bit. Ends the group.
    Returns the launches."""
    import numpy as np
    import torch.distributed as dist
    from stable_ts_tpu_torch import _build
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper import train
    from stable_ts_tpu_torch.models.whisper.model import init_params
    from stable_ts_tpu_torch.ops.mel import log_mel_spectrogram
    counts, reqs = {}, {}
    dq = WhisperTorch(dims, init_params(dims, seed=0, dtype=torch.bfloat16, device='cuda'),
                      device='cuda', name=MODEL + '-mesh-dq', ranks=ranks,
                      alignment_heads=heads, dq=True).shard(mesh)
    for name, n in batched_paths(torch, [(
            'mesh one batched dq', dq, long_audio[210 * SR:270 * SR],
            dict(batch_size=2, language='en', temperature=0, kv_quant=4),
            ('flash_attn', 'woq_matmul', 'cross_attn_decode_int4', 'logit_epilogue',
             'self_attn_decode', 'dtw_cost'))], reqs).items():
        counts[name] = counts.get(name, 0) + n
    ref = batched_reqs['batched dq']
    _same_words('mesh one batched dq', reqs['mesh one batched dq']['result'], ref['result'])
    log(f'[mesh one] batched dq 60 s: bit for bit the unsharded result; wall '
        f'{reqs["mesh one batched dq"]["wall"]:.3f} s sharded against {ref["wall"]:.3f} s')
    del dq
    torch.cuda.empty_cache()

    clips = np.stack([audio[:30 * SR], audio[30 * SR:60 * SR]])
    mel = log_mel_spectrogram(clips, n_mels=dims.n_mels, device='cuda')
    tokens = np.random.default_rng(5).integers(0, dims.n_vocab, (2, 64))
    init_opt_state, train_step = train.make_train_step(dims)
    out = {}
    for label in ('unsharded', 'sharded'):
        model = init_params(dims, seed=0, dtype=torch.bfloat16)
        if label == 'sharded':
            from stable_ts_tpu_torch.parallel import shard_params
            shard_params(model, mesh, dims)
        opt = init_opt_state(model)
        losses, walls = [], []
        for _ in range(2):
            _build.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(train_step(model, opt, mel, tokens).item())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = _build.launch_counts()
            if any(launches.get(k, 0) != 64 for k in ('flash_attn', 'flash_attn_bwd_dkv',
                                                       'flash_attn_bwd_dq')):
                raise AssertionError(f'mesh one train ({label}): launches {launches}')
            if label == 'sharded':
                for name, n in launches.items():
                    counts[name] = counts.get(name, 0) + n
        out[label] = (losses, walls, {n: p.detach().clone()
                                      for n, p in model.named_parameters()})
        del model, opt
        torch.cuda.empty_cache()
    (lu, wu, pu), (ls, ws, ps) = out['unsharded'], out['sharded']
    if lu != ls or any(not torch.equal(pu[n], ps[n]) for n in pu):
        raise AssertionError(f'mesh one train: losses {ls} != {lu} or weights differ')
    log(f'[mesh one] two train steps: losses {ls} and every weight bit for bit the '
        f'unsharded steps\'; walls {[round(w, 3) for w in ws]} s sharded against '
        f'{[round(w, 3) for w in wu]} s')
    del out, pu, ps
    torch.cuda.empty_cache()
    dist.destroy_process_group()
    return counts


# the two-rank phase: large-v3 at full width with its depth cut for the train
# steps (four layers a stack: four f32 replicas of the optimizer state at dp = 2
# would not fit beside each other on one card)
TRAIN_LAYERS = 4


# the two-rank phase's bf16 greedy, which is logged and not gated, stops
# after 48 tokens a window: every step there costs about 160 gloo
# all-reduces through the host at tp = 2 (the gated f32 greedy runs its
# full sample length)
BF16_SAMPLE_LEN = 48


def _summary(result) -> dict:
    """What the two-rank phase compares of a result: its text, its words
    (text, start, end, probability) and its word-level SRT."""
    return dict(text=result.text, srt=result.to_srt_vtt(word_level=True),
                words=[(w.word, w.start, w.end, w.probability)
                       for w in result.all_words()])


def _two_rank_requests(torch, model, audio, dtype_label: str):
    """The requests of the two-rank phase on ``model``, each with the
    launch counts reset before it and read after it: transcribe_batched
    greedy 60 s (one group of 2 windows; in bf16 48 tokens a window); with
    f32 weights also ``align_words`` of 20 s (two 10-s segments) and a
    refine of its result (``prob_threshold=0.0``). At 60 s the tp = 2
    ``align_words`` starts part from the unsharded ones by up to 0.42 s:
    a head score one bf16 step apart moves the DTW path over flat random
    attention, shown by ``tools/torch_mesh_divergence.py`` (PERF.md §6).
    Returns {name: (summary, wall, launches)}."""
    from stable_ts_tpu_torch import _build
    out, aligned = {}, []
    requests = [(f'greedy 60 s {dtype_label}', lambda: model.transcribe_batched(
        audio[:60 * SR], batch_size=2, language='en', temperature=0,
        sample_len=None if dtype_label == 'f32' else BF16_SAMPLE_LEN, verbose=None))]
    if dtype_label == 'f32':
        clip = audio[:20 * SR]
        requests += [
            ('align_words 20 s f32', lambda: aligned.append(model.align_words(
                clip, [dict(s) for s in align_words_grid(20.0)], language='en',
                verbose=None)) or aligned[0]),
            ('refine 20 s f32', lambda: model.refine(
                clip, aligned[0], inplace=False, prob_threshold=0.0, verbose=None))]
    for name, fn in requests:
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out[name] = (_summary(result), time.perf_counter() - t0, _build.launch_counts())
    return out


def _train_losses(torch, dims, mesh, audio, steps: int = 2):
    """Losses of ``steps`` train steps on the cut large-v3 (f32, seed 2),
    batch 2 windows and 64 tokens, sharded on ``mesh`` when given."""
    import numpy as np
    from stable_ts_tpu_torch.models.whisper import train
    from stable_ts_tpu_torch.models.whisper.model import init_params
    from stable_ts_tpu_torch.ops.mel import log_mel_spectrogram
    clips = np.stack([audio[:30 * SR], audio[30 * SR:60 * SR]])
    mel = log_mel_spectrogram(clips, n_mels=dims.n_mels, device='cuda')
    tokens = np.random.default_rng(5).integers(0, dims.n_vocab, (2, 64))
    model = init_params(dims, seed=2, dtype=torch.float32)
    if mesh is not None:
        from stable_ts_tpu_torch.parallel import shard_params
        shard_params(model, mesh, dims)
    init_opt_state, train_step = train.make_train_step(dims)
    opt = init_opt_state(model)
    losses = [train_step(model, opt, mel, tokens).item() for _ in range(steps)]
    return losses


def _rank_main(rank: int, port: int, out_dir: str, heads) -> None:
    """One of the two ranks of the two-rank phase (spawned; both on
    cuda:0, gloo collectives on CUDA tensors): for (dp 1, tp 2) and
    (dp 2, tp 1), the requests of :func:`_two_rank_requests` on large-v3
    f32 and bf16 weights (seed 0), and the cut model's train steps.
    Writes its results to ``out_dir/rank<rank>.pkl``."""
    import pickle
    import torch
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from stable_ts_tpu_torch import _build
    from stable_ts_tpu_torch.audio.synth import synth_speech_like
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper.dims import OPENAI_MODEL_DIMS, ModelDimensions
    from stable_ts_tpu_torch.models.whisper.model import init_params
    from stable_ts_tpu_torch.parallel import build_mesh, distributed_init
    _build.lib()
    distributed_init(f'127.0.0.1:{port}', 2, rank, backend='gloo')
    dims = ModelDimensions(**OPENAI_MODEL_DIMS[MODEL])
    train_dims = ModelDimensions(**{**vars(dims), 'n_audio_layer': TRAIN_LAYERS,
                                    'n_text_layer': TRAIN_LAYERS})
    ranks = synthetic_ranks()
    audio = synth_speech_like(155.0)
    out = {}
    for tp in (2, 1):
        mesh = build_mesh(tp=tp, devices='cuda')
        key = f'dp {mesh["dp"].size()} x tp {mesh["tp"].size()}'
        torch.cuda.reset_peak_memory_stats()
        reqs = {}
        for dtype, label in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
            model = WhisperTorch(dims, init_params(dims, seed=0, dtype=dtype,
                                                   device='cuda'),
                                 device='cuda', name=MODEL, ranks=ranks,
                                 alignment_heads=heads).shard(mesh)
            reqs.update(_two_rank_requests(torch, model, audio, label))
            del model
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        losses = _train_losses(torch, train_dims, mesh, audio)
        out[key] = dict(requests=reqs, losses=losses, train_s=time.perf_counter() - t0,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f'rank{rank}.pkl'), 'wb') as f:
        pickle.dump(out, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def synthetic_ranks() -> dict:
    """The synthetic rank table the size of the multilingual vocabulary
    (bench.py's)."""
    ranks = {bytes([b]): b for b in range(256)}
    i = 256
    while len(ranks) < 50257:
        ranks[b'\x00' + i.to_bytes(3, 'big')] = i
        i += 1
    return ranks


def mesh_two(torch, heads) -> dict:
    """Two ranks on the one card over gloo (two spawned processes, both on
    cuda:0; NCCL refuses two ranks on one GPU), the only way a tp or dp
    split runs on a one-GPU machine. This process first runs the
    unsharded references of :func:`_two_rank_requests` (f32 and bf16) and
    the cut model's two train steps. Then for (dp 1, tp 2) and (dp 2, tp
    1) each rank must launch the kernels of each request and give, in
    f32, the reference's text and words with every start within 0.021 s
    and train losses within 1e-4 relative; the bf16 greedy's differences
    are logged, not gated. Both ranks must return the same results. Logs
    each request's wall on each rank (the ranks share the card: not a
    speed-up) and each rank's peak device memory. Returns the launches of
    rank 0."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    from stable_ts_tpu_torch.audio.synth import synth_speech_like
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper.dims import OPENAI_MODEL_DIMS, ModelDimensions
    from stable_ts_tpu_torch.models.whisper.model import init_params
    dims = ModelDimensions(**OPENAI_MODEL_DIMS[MODEL])
    train_dims = ModelDimensions(**{**vars(dims), 'n_audio_layer': TRAIN_LAYERS,
                                    'n_text_layer': TRAIN_LAYERS})
    audio = synth_speech_like(155.0)
    ranks = synthetic_ranks()
    refs = {}
    for dtype, label in ((torch.float32, 'f32'), (torch.bfloat16, 'bf16')):
        model = WhisperTorch(dims, init_params(dims, seed=0, dtype=dtype, device='cuda'),
                             device='cuda', name=MODEL, ranks=ranks, alignment_heads=heads)
        refs.update(_two_rank_requests(torch, model, audio, label))
        del model
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref_losses = _train_losses(torch, train_dims, None, audio)
    train_wall = time.perf_counter() - t0
    torch.cuda.empty_cache()
    log('[mesh two] unsharded: ' + ', '.join(f'{name} {wall:.3f} s'
                                             for name, (_, wall, _) in refs.items())
        + f'; the cut model ({TRAIN_LAYERS} + {TRAIN_LAYERS} layers, f32) two train '
        f'steps {train_wall:.3f} s, losses {ref_losses}')

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mp.spawn(_rank_main, args=(_free_port(), tmp, heads), nprocs=2, join=True)
        log(f'[mesh two] two ranks spawned and joined in {time.perf_counter() - t0:.1f} s')
        got = []
        for rank in range(2):
            with open(os.path.join(tmp, f'rank{rank}.pkl'), 'rb') as f:
                got.append(pickle.load(f))
    counts = {}
    for key in got[0]:
        r0, r1 = got[0][key], got[1][key]
        log(f'[mesh two] {key}: walls rank 0 / rank 1 (unsharded): ' + ', '.join(
            f'{name} {r0["requests"][name][1]:.3f} / {r1["requests"][name][1]:.3f} s '
            f'({refs[name][1]:.3f})' for name in r0['requests'])
            + f'; train {r0["train_s"]:.3f} / {r1["train_s"]:.3f} s ({train_wall:.3f}); '
            f'peak device memory {r0["peak_gb"]:.2f} / {r1["peak_gb"]:.2f} GB')
        if ({k: v[0] for k, v in r0['requests'].items()}
                != {k: v[0] for k, v in r1['requests'].items()}
                or r0['losses'] != r1['losses']):
            raise AssertionError(f'mesh two {key}: the ranks returned different results')
        for name, (res, wall, launches) in r0['requests'].items():
            ref = refs[name][0]
            need = (('flash_attn', 'self_attn_decode', 'cross_attn_decode',
                     'logit_epilogue', 'dtw_cost') if name.startswith('greedy')
                    else ('flash_attn', 'dtw_cost') if name.startswith('align')
                    else ('flash_attn',))
            missing = [k for k in need if launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f'mesh two {key} {name}: kernels not launched: {missing}')
            for k, n in launches.items():
                counts[k] = counts.get(k, 0) + n
            same_text = (res['text'] == ref['text']
                         and [w[0] for w in res['words']] == [w[0] for w in ref['words']])
            diff = max((abs(a[1] - b[1]) for a, b in zip(res['words'], ref['words'])),
                       default=0.0)
            log(f'[mesh two] {key} {name}: text and words equal to the unsharded run\'s '
                f'{same_text}, {len(res["words"])} against {len(ref["words"])} words, '
                f'largest start difference {diff:.3f} s, SRT bytes equal '
                f'{res["srt"] == ref["srt"]}; launches {launches}')
            if name.endswith('f32') and (not same_text or diff > 0.021):
                raise AssertionError(f'mesh two {key} {name}: the f32 result differs from '
                                     f'the unsharded one')
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0['losses'], ref_losses))
        log(f'[mesh two] {key}: train losses {r0["losses"]}, relative difference to the '
            f'unsharded {rel:.2e}')
        if rel > 1e-4:
            raise AssertionError(f'mesh two {key}: train losses {r0["losses"]} against '
                                 f'{ref_losses} (relative {rel:.2e} > 1e-4)')
    return counts

if __name__ == '__main__':
    sys.exit(main())
