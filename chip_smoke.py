#!/usr/bin/env python3
"""GPU smoke test of stable_ts_tpu_torch: builds the CUDA kernels, holds
each against its plain PyTorch twin, then drives three paths on Whisper
large-v3 (random bf16 weights from a seed, the canonical alignment heads,
a synthetic rank table the size of the multilingual vocabulary) through
``WhisperTorch.transcribe``:

- greedy: 75 s and 20 s with language='en', temperature=0 (the logit
  epilogue on every step);
- beam: 30 s with no language (detect_language) and beam_size=5;
- ladder: 30 s on temperature=(0.0, 0.4, 0.8) with best_of=5 (random
  weights fail every rung, so every rung runs).

The launch counts are reset before each path and read after it; the script
fails unless each path launched the kernels it runs, all seven entries
among them.

    python3 chip_smoke.py        # needs one CUDA GPU; exits non-zero on any failure

The second-to-last line of stdout is a JSON object with each kernel's
launches on the three paths, its error against its twin and both times;
the last line is {"ok": true, "device": {...}}. Without a GPU, or without
the package beside it, the script fails and prints no result.
"""
import copy
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

SR = 16000
MODEL = 'large-v3'
HEADS_TINY = [(0, 1), (1, 0), (1, 1)]


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


def rel_err(got, ref) -> tuple:
    """(max |got - ref|, that over max |ref|), in f32."""
    diff = (got.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    return diff, diff / max(scale, 1e-30)


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
        ms = cuda_ms(lambda: flash_attn.flash_attention(q, k, v, h, scale))
        plain = cuda_ms(lambda: flash_attn.flash_attention_ref(q, k, v, h, scale))
        log(f'[kernel] flash_attn {what}: kernel {ms:.4f} ms, twin {plain:.4f} ms')
        flash.append((err, ms, plain))
    results['flash_attn'] = dict(max_abs_err=flash[0][0], ms=flash[0][1],
                                 plain_ms=flash[0][2])

    # D, self entry: one layer of the (32, 1, 256, 1280) int8 row cache, pos 200
    layers, ctx, pos = 32, 256, 200
    for what, cdtype, tol in (('int8 cache (32,1,256,1280) pos 200', torch.int8, 1e-4),
                              ('f32 cache (32,1,256,1280) pos 200', torch.float32, 1e-4)):
        raw = randn(layers, 1, ctx, d)
        raw_v = randn(layers, 1, ctx, d)
        if cdtype == torch.int8:
            from stable_ts_tpu_torch.models.whisper.model import quantize_rows
            kc, ks = quantize_rows(raw)
            vc, vs = quantize_rows(raw_v)
        else:
            kc, vc, ks, vs = raw, raw_v, None, None
        q = randn(1, d) * scale
        lay = 5
        args = (q, kc[lay], vc[lay], None if ks is None else ks[lay],
                None if vs is None else vs[lay], pos, h)
        got = self_attn.self_attn_decode(*args)
        ref = self_attn.self_attn_decode_ref(*args)
        torch.cuda.synchronize()
        err = check('self_attn_decode', got, ref, tol, what)
        ms = cuda_ms(lambda: self_attn.self_attn_decode(*args), iters=200)
        plain = cuda_ms(lambda: self_attn.self_attn_decode_ref(*args), iters=200)
        log(f'[kernel] self_attn_decode {what}: kernel {ms:.4f} ms, twin {plain:.4f} ms')
        if cdtype == torch.int8:
            results['self_attn_decode'] = dict(max_abs_err=err, ms=ms, plain_ms=plain)

    # D, cross entry: int8 K/V (32, 1, 2, 1500, 1280), s = 1500
    for what, quant in (('int8 kv (32,1,2,1500,1280)', True),
                        ('f32 kv (32,1,2,1500,1280)', False)):
        kv = randn(layers, 1, 2, 1500, d)
        sc = torch.ones((layers, 1, 2, 1500), device=dev)
        if quant:
            from stable_ts_tpu_torch.models.whisper.model import quantize_rows
            kv, sc = quantize_rows(kv)
        q = randn(1, d) * scale
        got = cross_attn.cross_attn_decode(q, kv, sc, 7, 1500, h)
        ref = cross_attn.cross_attn_decode_ref(q, kv[7, :, 0], kv[7, :, 1],
                                               sc[7, :, 0], sc[7, :, 1], 1500, h)
        torch.cuda.synchronize()
        # both round q and the weights to bf16 at the same places; a weight
        # whose f32 value differs in its last bit may round the other way
        err = check('cross_attn_decode', got, ref, 1e-3, what)
        ms = cuda_ms(lambda: cross_attn.cross_attn_decode(q, kv, sc, 7, 1500, h),
                     iters=200)
        plain = cuda_ms(lambda: cross_attn.cross_attn_decode_ref(
            q, kv[7, :, 0], kv[7, :, 1], sc[7, :, 0], sc[7, :, 1], 1500, h),
            iters=200)
        log(f'[kernel] cross_attn_decode {what}: kernel {ms:.4f} ms, twin {plain:.4f} ms')
        if quant:
            results['cross_attn_decode'] = dict(max_abs_err=err, ms=ms, plain_ms=plain)

    # W: a (1, 226, 1500) attention-like cost (negated, median-filtered
    # z-scores of a softmax), the largest the timing pass hands it
    from stable_ts_tpu_torch.models.whisper.timing import legacy_head_weights
    qk = (randn(3, 230, 1500) * 4).to(torch.bfloat16)
    mat = legacy_head_weights(qk, 1500, 3, 1.0, 7).mean(0)
    x = -mat[None].float().contiguous()
    got = dtw.dtw_cost(x)
    ref = dtw.dtw_cost_ref(x)
    torch.cuda.synchronize()
    # the INF (1e30) borders must match exactly; the finite costs within
    # 1e-6 of the largest finite cost (the kernel and the twin round the
    # same f64 prefix sums, so they normally agree bit for bit)
    border = ref >= 1e29
    if not bool(((got >= 1e29) == border).all()):
        raise AssertionError('dtw_cost: INF borders differ from the twin')
    err = check('dtw_cost', torch.where(border, 0.0, got),
                torch.where(border, 0.0, ref), 1e-6, 'cost (1,226,1500) f32')
    n, m = mat.shape
    jk = dtw.dtw_jumps(got[0].cpu().numpy(), n, m)
    jr = dtw.dtw_jumps(ref[0].cpu().numpy(), n, m)
    same = bool((jk == jr).all())
    log(f'[kernel] dtw_cost jump frames identical to the twin\'s: {same} '
        f'({n} tokens, {m} frames)')
    if not same:
        raise AssertionError('DTW jump frames differ between kernel and twin')
    ms = cuda_ms(lambda: dtw.dtw_cost(x))
    plain = cuda_ms(lambda: dtw.dtw_cost_ref(x), iters=3, warmup=1)
    log(f'[kernel] dtw_cost (1,226,1500): kernel {ms:.4f} ms, twin {plain:.4f} ms')
    results['dtw_cost'] = dict(max_abs_err=err, ms=ms, plain_ms=plain)

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
    ms = cuda_ms(lambda: cross_attn.cross_attn_decode(*args, q_per_kv=g), iters=200)
    plain = cuda_ms(lambda: cross_attn.cross_attn_decode_ref(*ref_args), iters=200)
    log(f'[kernel] cross_attn_decode_group {what}: kernel {ms:.4f} ms, twin {plain:.4f} ms')
    results['cross_attn_decode_group'] = dict(max_abs_err=err, ms=ms, plain_ms=plain)

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
    ms = cuda_ms(lambda: self_attn.self_attn_decode(*args, anc=anc, q_per_kv=rows),
                 iters=200)
    plain = cuda_ms(lambda: self_attn.self_attn_decode_ref(*args, anc=anc,
                                                           q_per_kv=rows), iters=200)
    log(f'[kernel] self_attn_decode_beam {what}: kernel {ms:.4f} ms, twin {plain:.4f} ms')
    results['self_attn_decode_beam'] = dict(max_abs_err=err, ms=ms, plain_ms=plain)

    epilogue_checks(torch, results, randn, gen)


def epilogue_checks(torch, results: dict, randn, gen) -> None:
    """The logit epilogue at large-v3 shapes (emb (51866, 1280) bf16) for
    B = 1 and 5, with a suppress list, a silence mask and grammar flags that
    differ across rows. Aggregates within 1e-3 relative; argmax ids equal
    wherever the top two filtered logits of a part differ by more than
    that."""
    from stable_ts_tpu_torch.ops import logit_epilogue as epi
    v, d, ts_begin, eot = 51866, 1280, 50365, 50257
    emb = (randn(v, d) * 0.02).to(torch.bfloat16)
    suppress = torch.where(torch.rand(v, generator=gen, device='cuda') < 0.02,
                           -1e9, 0.0)
    for b in (1, 5):
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
        ms = cuda_ms(lambda: epi.fused_logit_aggregates(*args), iters=50)
        plain = cuda_ms(lambda: epi.fused_logit_aggregates_ref(*args), iters=20)
        log(f'[kernel] logit_epilogue {what}: kernel {ms:.4f} ms, twin {plain:.4f} ms')
        if b == 1:
            results['logit_epilogue'] = dict(max_abs_err=err, ms=ms, plain_ms=plain)


def tiny_parity(torch) -> None:
    """The tiny f32 model transcribes the same seeded audio alike on the
    CPU (every op through its twin) and on the GPU (through the kernels)."""
    import numpy as np
    from stable_ts_tpu_torch.loaders import WhisperTorch, load_test_model
    cpu = load_test_model(seed=0, alignment_heads=HEADS_TINY)
    gpu = WhisperTorch(cpu.dims, copy.deepcopy(cpu.params), device='cuda',
                       name='test-tiny', ranks=cpu._ranks,
                       alignment_heads=HEADS_TINY)
    audio = (np.random.default_rng(21).standard_normal(SR * 40) * 0.1
             ).astype(np.float32)
    kw = dict(language='en', temperature=0, verbose=None, kv_quant=True)
    rc, rg = cpu.transcribe(audio, **kw), gpu.transcribe(audio, **kw)
    words_c = [(w.start, w.end) for s in rc.segments for w in s.words]
    words_g = [(w.start, w.end) for s in rg.segments for w in s.words]
    worst = max((max(abs(a[0] - b[0]), abs(a[1] - b[1]))
                 for a, b in zip(words_c, words_g)), default=0.0)
    ok = (rc.text == rg.text and len(words_c) == len(words_g) and worst <= 0.021)
    log(f'[tiny] f32 tiny model, 40 s: CPU twins vs GPU kernels: text equal '
        f'{rc.text == rg.text}, {len(words_c)} vs {len(words_g)} words, '
        f'worst word-time gap {worst:.3f} s (bound 0.021) {"OK" if ok else "FAIL"}')
    if not ok:
        raise AssertionError('tiny model: GPU transcription differs from CPU')


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
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    log(f'[build] {lib_path.relative_to(HERE)} in {time.perf_counter() - t0:.1f} s')

    results = {}
    kernel_checks(torch, results)
    tiny_parity(torch)

    # -- the paths on large-v3: greedy, beam with language detection, ladder -----------
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper import alignment_heads
    from stable_ts_tpu_torch.models.whisper.dims import (OPENAI_MODEL_DIMS,
                                                         ModelDimensions)
    from stable_ts_tpu_torch.models.whisper.model import init_params

    dims = ModelDimensions(**OPENAI_MODEL_DIMS[MODEL])
    t0 = time.perf_counter()
    params = init_params(dims, seed=0, dtype=torch.bfloat16, device='cuda')
    # synthetic rank table the size of the multilingual vocabulary (bench.py)
    ranks = {bytes([b]): b for b in range(256)}
    i = 256
    while len(ranks) < 50257:
        ranks[b'\x00' + i.to_bytes(3, 'big')] = i
        i += 1
    model = WhisperTorch(dims, params, device='cuda', name=MODEL, ranks=ranks,
                         alignment_heads=alignment_heads.get_alignment_heads(
                             MODEL, dims.n_text_layer, dims.n_text_head))
    torch.cuda.synchronize()
    log(f'[model] {model} built in {time.perf_counter() - t0:.1f} s, '
        f'{len(model.alignment_heads)} alignment heads')

    counts = drive_paths(torch, model)
    if 'jax' in sys.modules:
        raise AssertionError('jax was imported')

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
    }
    kernels = [dict(name=name, route='cuda', source=meta[name][0],
                    replaces=meta[name][1], launches=counts.get(name, 0),
                    **results[name])
               for name in meta]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def drive_paths(torch, model) -> dict:
    """Drive the greedy, beam and ladder paths on ``model``; returns the
    kernel launches summed over the paths."""
    from bench import synth_speech_like
    from stable_ts_tpu_torch import _build
    # host-clock phase split (each phase ends in a device synchronize); the
    # decoder steps are counted at decoding.decoder_step
    import stable_ts_tpu_torch.models.whisper.decoding as decoding
    import stable_ts_tpu_torch.transcribe as driver
    phases, rungs, steps = {}, [], [0]

    def timed(fn, phase):
        def inner(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phases[phase] = phases.get(phase, 0.0) + time.perf_counter() - t
            if phase == 'decode':
                opts = a[1]
                rungs.append((opts.temperature, opts.best_of, opts.beam_size))
            return out
        return inner

    def counted_step(*a, **kw):
        steps[0] += 1
        return step_fn(*a, **kw)

    step_fn = decoding.decoder_step
    decoding.decoder_step = counted_step
    model.embed_audio = timed(model.embed_audio, 'encode')
    model.detect_language = timed(model.detect_language, 'detect_language')
    model.decode = timed(model.decode, 'decode')
    driver.add_word_timestamps = timed(driver.add_word_timestamps, 'word_timing')

    audio = synth_speech_like(155.0)
    ladder = (0.0, 0.4, 0.8)
    # (path, request label, clip, transcribe options, kernels the path must launch)
    paths = [
        ('greedy', [('75 s', audio[:75 * SR]), ('20 s', audio[75 * SR:95 * SR])],
         dict(language='en', temperature=0),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue',
          'dtw_cost')),
        ('beam', [('30 s, no language, beam_size=5', audio[95 * SR:125 * SR])],
         dict(temperature=0, beam_size=5),
         ('flash_attn', 'self_attn_decode_beam', 'cross_attn_decode_group',
          'dtw_cost')),
        ('ladder', [('30 s, temperature=(0.0, 0.4, 0.8), best_of=5',
                     audio[125 * SR:155 * SR])],
         dict(language='en', temperature=ladder, best_of=5),
         ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'logit_epilogue',
          'cross_attn_decode_group', 'dtw_cost')),
    ]
    counts = {}
    for path, requests, options, needed in paths:
        _build.reset_launch_counts()
        for label, clip in requests:
            duration = clip.shape[-1] / SR
            phases.clear()
            rungs.clear()
            steps[0] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            result = model.transcribe(clip, verbose=None, **options)
            srt = result.to_srt_vtt(word_level=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n_words = check_result(result, srt, duration)
            check_rungs(path, rungs, result, ladder)
            split = ', '.join(f'{k} {v:.3f} s' for k, v in phases.items())
            log(f'[{path}] request {label}: wall {wall:.3f} s '
                f'({wall / duration:.4f} s per audio second), language '
                f'{result.language}, {len(result.segments)} segments, {n_words} '
                f'words, srt {len(srt)} bytes; {len(rungs)} decode calls '
                f'{sorted(set(rungs), key=str)}, {steps[0]} decoder steps '
                f'({phases["decode"] / (steps[0] + len(rungs)) * 1e3:.2f} ms per '
                f'step or prefill); {split}, other '
                f'{wall - sum(phases.values()):.3f} s')
        path_counts = _build.launch_counts()
        log(f'[{path}] kernel launches on this path: {path_counts}')
        for name in needed:
            if path_counts.get(name, 0) <= 0:
                raise AssertionError(f'kernel {name} was not launched on the '
                                     f'{path} path')
        for name, n in path_counts.items():
            counts[name] = counts.get(name, 0) + n
    return counts


def check_rungs(path: str, rungs: list, result, ladder: tuple) -> None:
    """The decode calls each request made: greedy and beam decode each
    window once at temperature 0; the ladder, with random weights whose
    avg_logprob is far below -1, runs every rung of every window in order,
    best_of only above 0, and the segments keep the last rung."""
    if path == 'ladder':
        want = [(t, 5 if t > 0 else None, None) for t in ladder]
        if not rungs or rungs != want * (len(rungs) // len(want)):
            raise AssertionError(f'ladder rungs {rungs}, expected repeats of {want}')
        temps = {s.temperature for s in result.segments}
        if temps != {ladder[-1]}:
            raise AssertionError(f'segment temperatures {temps} != {{{ladder[-1]}}}')
    else:
        beam = 5 if path == 'beam' else None
        if set(rungs) != {(0, None, beam)}:
            raise AssertionError(f'{path} decode calls {set(rungs)}')


if __name__ == '__main__':
    sys.exit(main())
