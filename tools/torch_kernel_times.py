#!/usr/bin/env python3
"""Device times of stable_ts_tpu_torch's decode-attention entries (self,
its position given on the host and, where the tree can read it there, on
the device; beam; cross, at one window and at the batched groups' 8 and
32 windows, the 32 also through addresses read on the device, as the
greedy step's graph calls it), vocab projection, weight-only matmul, greedy
logit epilogue (beside torch.mm of the same product, its yardstick) and
DTW cost at Whisper large-v3's shapes, and of an empty launch where the
tree has one, for the package found under ROOT (default: this checkout).

    python3 tools/torch_kernel_times.py [ROOT ...]

Each ROOT is timed in its own process, in the order given, so two trees of
the package (an older checkout unpacked beside this one, and this one) can
be held against each other on the same card in one run: list them as A B B
A. Each process builds ROOT's kernels and prints one JSON line: the card's
name and power limit, then for each entry its device time alone (the
profiler's kernel durations, ``chip_smoke.device_ms``) and its CUDA-event
time (``chip_smoke.cuda_ms``, which also reads the wrapper's host time),
both in ms per call; each cross entry also gives the bytes it must read
and write (``perfbench/roofline.py``'s count) over its device time, in
TB/s and as a share of the H100's 3.35 TB/s. Needs one CUDA GPU.
"""
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_TB_S = 3.35   # H100 SXM data sheet


def time_root(root: str) -> dict:
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, root)
    import torch
    from stable_ts_tpu_torch import _build
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.models.whisper.quantization import quantize_weight
    from stable_ts_tpu_torch.ops import (cross_attn, dtw, logit_epilogue, self_attn,
                                         vocab_proj, woq_matmul)
    import stable_ts_tpu_torch
    package = os.path.dirname(stable_ts_tpu_torch.__file__)
    if package != os.path.join(root, 'stable_ts_tpu_torch'):
        raise SystemExit(f'torch_kernel_times: imported {package}, not the one under {root}')
    if not torch.cuda.is_available():
        raise SystemExit('torch_kernel_times: no CUDA device')
    gen = torch.Generator(device='cuda').manual_seed(1234)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device='cuda')

    def both(fn, iters):
        return dict(device_ms=chip_smoke.device_ms(fn, iters=iters),
                    event_ms=chip_smoke.cuda_ms(fn, iters=iters))

    layers, d, h, s = 32, 1280, 20, 1500
    times = {}

    def cross(name, fn, kv, rows, iters):
        """The entry's times, and the bytes it must move (K/V rows and
        their scales, query and output) over its device time."""
        times[name] = both(fn, iters)
        nbytes = (2 * kv.shape[1] * s * (kv.shape[-1] * kv.element_size() + 4)
                  + 2 * rows * d * 4)
        tb_s = nbytes / times[name]['device_ms'] / 1e9
        times[name].update(bytes=nbytes, tb_s=round(tb_s, 3),
                           hbm_share=round(tb_s / HBM_TB_S, 3))
    kv8, sc8 = quantize_rows(randn(layers, 1, 2, s, d))
    vals4, sc4 = quantize_rows(randn(layers, 1, 2, s, d), bits=4)
    kv4 = cross_attn.pack_int4(vals4)
    for g in (1, 5):
        q = randn(g, d) * (d // h) ** -0.5
        cross(f'cross int8 g={g}',
              lambda: cross_attn.cross_attn_decode(q, kv8, sc8, 7, s, h, q_per_kv=g), kv8, g,
              200)
        cross(f'cross int4 g={g}',
              lambda: cross_attn.cross_attn_decode(q, kv4, sc4, 7, s, h, q_per_kv=g, bits=4),
              kv4, g, 200)
    bf16_kv = randn(2, 1, 2, s, d).to(torch.bfloat16)
    ones = torch.ones((2, 1, 2, s), device='cuda')
    q = randn(1, d) * (d // h) ** -0.5
    cross('cross bf16 g=1 (locate)',
          lambda: cross_attn.cross_attn_decode(q, bf16_kv, ones, 1, s, h), bf16_kv, 1, 200)
    del kv8, sc8, kv4, vals4, sc4, bf16_kv
    # the batched groups: one query row a window over 8 and 32 windows, the
    # 32 also as the step graph calls it (K/V and scale addresses on the device)
    for windows in (8, 32):
        kvw, scw = quantize_rows(randn(2, windows, 2, s, d))
        q = randn(windows, d) * (d // h) ** -0.5
        cross(f'cross int8 {windows} rows',
              lambda: cross_attn.cross_attn_decode(q, kvw, scw, 1, s, h), kvw, windows, 100)
        if windows == 32:
            layout_kv, layout_sc = torch.empty_like(kvw), torch.empty_like(scw)
            bases = torch.tensor([kvw.data_ptr(), scw.data_ptr()], device='cuda')
            cross(f'cross int8 {windows} rows, addresses on the device',
                  lambda: cross_attn.cross_attn_decode_indirect(
                      q, layout_kv, layout_sc, bases, 1, s, h), kvw, windows, 100)
            del layout_kv, layout_sc
        del kvw, scw
    # the self and beam entries on one layer of an int8 row cache, pos 200
    pos, ctx = 200, 256
    for rows, g in ((1, 1), (5, 5)):
        kc, ks = quantize_rows(randn(layers, rows, ctx, d))
        vc, vs = quantize_rows(randn(layers, rows, ctx, d))
        q = randn(rows, d) * (d // h) ** -0.5
        args = (q, kc[5], vc[5], ks[5], vs[5], pos, h)
        if g == 1:
            times['self int8 pos 200'] = both(lambda: self_attn.self_attn_decode(*args), 200)
            if len(_build._SIGNATURES['self_attn_decode']) > 15:
                # the position read on the device, as the greedy step's graph does
                pos_dev = torch.tensor(pos, device='cuda')
                dev_args = args[:5] + (pos_dev, h)
                times['self int8 pos 200, device pos'] = both(
                    lambda: self_attn.self_attn_decode(*dev_args), 200)
        else:
            anc = torch.randint(0, g, (rows, ctx), generator=gen, device='cuda',
                                dtype=torch.int32)
            anc[:, pos] = torch.arange(rows, device='cuda', dtype=torch.int32)
            times['beam int8 pos 200 g=5'] = both(
                lambda: self_attn.self_attn_decode(*args, anc=anc, q_per_kv=g), 200)
    # the dq linears' largest shape, (K, N) = (1280, 5120): decode and encoder
    wq, wscale = quantize_weight(randn(5120, d) * 0.02)
    for m in (1, 5, 1500):
        x = randn(m, d).to(torch.bfloat16)
        times[f'woq_matmul M={m} (1280,5120)'] = both(
            lambda: woq_matmul._woq_cuda(x, wq, wscale), 200 if m <= 5 else 20)
    if 'empty_launch' in _build._SIGNATURES:
        lib, stream = _build.lib(), torch.cuda.current_stream().cuda_stream
        times['empty launch (20 blocks of 128)'] = both(
            lambda: _build.check(lib.empty_launch(20, 128, stream), 'empty_launch'), 200)
    emb = (randn(51866, d) * 0.02).to(torch.bfloat16)
    for m in (1, 5, 16, 64, 256):
        x = randn(m, d).to(torch.bfloat16)
        times[f'vocab_proj M={m}'] = both(lambda: vocab_proj.vocab_proj(x, emb), 50)
        times[f'torch.mm M={m}'] = both(
            lambda: torch.mm(x, emb.t(), out_dtype=torch.float32), 50)
    # the greedy epilogue at chip_smoke.py's shapes: a suppress list, a
    # silence mask on the timestamps, grammar flags that differ across rows
    v, ts_begin, eot = 51866, 50365, 50257
    suppress = torch.where(torch.rand(v, generator=gen, device='cuda') < 0.02, -1e9, 0.0)
    for b in (1, 5):
        x = randn(b, d).to(torch.bfloat16)
        sil = torch.zeros((b, v), device='cuda')
        sil[:, ts_begin:] = torch.where(
            torch.rand((b, v - ts_begin), generator=gen, device='cuda') < 0.3, -1e9, 0.0)
        r = torch.arange(b, device='cuda')
        flags = torch.stack([(r % 3 == 1).long(), (r % 3 == 2).long(),
                             (r % 2 == 0).long(), (r * 211) % 700], 1).int()
        times[f'logit_epilogue B={b}'] = both(lambda: logit_epilogue.fused_logit_aggregates(
            x, emb, suppress, sil, flags, ts_begin, eot, True), 50)
        times[f'torch.mm B={b} (the epilogue\'s product alone)'] = both(
            lambda: torch.mm(x, emb.t(), out_dtype=torch.float32), 50)
    cost_in = randn(1, 226, s)
    times['dtw_cost (1,226,1500)'] = both(lambda: dtw.dtw_cost(cost_in), 20)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    return dict(root=root, package=package, card=smi, times=times)


def main(argv) -> int:
    if len(argv) == 1 and argv[0].startswith('--one='):
        print(json.dumps(time_root(argv[0][len('--one='):])), flush=True)
        return 0
    for root in argv or [HERE]:
        # the children run from HERE: resolve ROOT against the caller's directory
        root = os.path.abspath(root)
        if not os.path.isdir(os.path.join(root, 'stable_ts_tpu_torch')):
            raise SystemExit(f'torch_kernel_times: no stable_ts_tpu_torch under {root}')
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), f'--one={root}'],
                              cwd=HERE)
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
