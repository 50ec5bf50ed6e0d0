#!/usr/bin/env python3
"""GPU smoke test of stable_ts_tpu_torch: builds the CUDA kernels, holds
each against its plain PyTorch twin, then answers two transcription
requests on Whisper large-v3 (random bf16 weights from a seed, the
canonical alignment heads, a synthetic rank table the size of the
multilingual vocabulary) through ``WhisperTorch.transcribe`` and checks
that the main path went through all four kernels.

    python3 chip_smoke.py        # needs one CUDA GPU; exits non-zero on any failure

The second-to-last line of stdout is a JSON object with each kernel's
launches on the main path, its error against its twin and both times; the
last line is {"ok": true, "device": {...}}. Without a GPU, or without the
package beside it, the script fails and prints no result.
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
    """Every kernel against its twin at the slice's large-v3 shapes (bf16
    activations, int8 caches) and at one f32 shape."""
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

    # -- the slice: large-v3, two requests --------------------------------------------
    from bench import synth_speech_like
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
    log(f'[slice] {model} built in {time.perf_counter() - t0:.1f} s, '
        f'{len(model.alignment_heads)} alignment heads')

    # host-clock phase split (each phase ends in a device synchronize)
    import stable_ts_tpu_torch.transcribe as driver
    phases, tokens = {}, []

    def timed(fn, phase):
        def inner(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            phases[phase] = phases.get(phase, 0.0) + time.perf_counter() - t
            if phase == 'decode':
                tokens.extend(len(r.tokens) + 1 for r in out)
            return out
        return inner

    model.embed_audio = timed(model.embed_audio, 'encode')
    model.decode = timed(model.decode, 'decode')
    driver.add_word_timestamps = timed(driver.add_word_timestamps, 'word_timing')

    audio = synth_speech_like(95.0)
    requests = [('75 s', audio[:75 * SR]), ('20 s', audio[75 * SR:])]
    _build.reset_launch_counts()
    for label, clip in requests:
        duration = clip.shape[-1] / SR
        phases.clear()
        tokens.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = model.transcribe(clip, language='en', temperature=0,
                                  verbose=None)
        srt = result.to_srt_vtt(word_level=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_words = check_result(result, srt, duration)
        split = ', '.join(f'{k} {v:.3f} s' for k, v in phases.items())
        log(f'[slice] request {label}: wall {wall:.3f} s '
            f'({wall / duration:.4f} s per audio second), '
            f'{len(result.segments)} segments, {n_words} words, '
            f'srt {len(srt)} bytes; {len(tokens)} windows, {sum(tokens)} '
            f'decode steps ({phases["decode"] / sum(tokens) * 1e3:.2f} ms per '
            f'step incl. prefill); {split}, other '
            f'{wall - sum(phases.values()):.3f} s')
    counts = _build.launch_counts()
    log(f'[slice] kernel launches on the main path: {counts}')
    for name in ('flash_attn', 'self_attn_decode', 'cross_attn_decode', 'dtw_cost'):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f'kernel {name} was not launched on the main path')
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
    }
    kernels = [dict(name=name, route='cuda', source=meta[name][0],
                    replaces=meta[name][1], launches=counts[name], **results[name])
               for name in meta]
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
