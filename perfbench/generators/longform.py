"""Long files through the batched driver: ``transcribe_batched`` at a fixed
window batch, greedy, then the SRT.

Parameters (``perfbench/traffic/<mix>.json``): ``minutes`` and
``sample_len``, the files' lengths and decode lengths in serving order;
``batch_size``; ``language``; ``warmup_sample_len``; ``check_windows``,
how many windows the check reads. The check takes windows of the
files served, never a file's last window (a last window that is silent
would be skipped, and the count would shift), with the window of the most
served tokens among them.
"""
import math

import numpy as np

from perfbench import flops
from perfbench.core import audio as audio_mod
from perfbench.core.workload import Workload as Base

N_SAMPLES = 480000

# the per-layer metrics a CPU run cannot report: it records no CUDA
# events and its profile holds no device time
CARD_ONLY = ('encoder_device_ms_per_window.transcribe', 'kernel_roofline.transcribe',
             'device_idle.transcribe')


def tiny(params: dict) -> None:
    """The mix shrunk in place for the CPU tests: two short files, a few
    tokens a window, two windows a group."""
    params.update(minutes=[1.2, 0.7], sample_len=[8, 10], batch_size=2,
                  warmup_sample_len=3, check_windows=3)


def break_tokens(monkeypatch):
    """Every third greedy pick moved to the id below."""
    from stable_ts_tpu_torch.models.whisper import decoding
    orig = decoding.select_from_aggregates
    calls = [0]

    def altered(agg, with_grammar=True):
        tok, lp = orig(agg, with_grammar)
        calls[0] += 1
        return ((tok - 1).clamp(min=0) if calls[0] % 3 == 0 else tok), lp
    monkeypatch.setattr(decoding, 'select_from_aggregates', altered)


def break_no_speech(monkeypatch):
    """Each window's no-speech probability, an answer of the decode, scaled
    tenfold where the results are built."""
    from stable_ts_tpu_torch import loaders
    orig = loaders._decode_collect

    def altered(pending, with_features=True):
        results = orig(pending, with_features=with_features)
        for r in results:
            r.no_speech_prob *= 10.0
        return results
    monkeypatch.setattr(loaders, '_decode_collect', altered)


# the faults the CPU tests plant in the timed path: a greedy step's token,
# and an answer of the decode where the results are built
FAULTS = (break_tokens, break_no_speech)


class Workload(Base):
    kind = 'longform'

    def sizes(self):
        p = self.params
        return [dict(seconds=60.0 * m, sample_len=int(s))
                for m, s in zip(p['minutes'], p['sample_len'])]

    def _options(self, sample_len):
        p = self.params
        return dict(batch_size=p['batch_size'], language=p['language'], verbose=None,
                    temperature=0.0, sample_len=sample_len)

    def warmup(self, model):
        speech = audio_mod.speech_like(30.0 * self.params['batch_size'],
                                       (self.seed, 'warmup'), self.device)
        result = model.transcribe_batched(
            speech.pcm, **self._options(self.params['warmup_sample_len']))
        result.to_srt_vtt()

    def install(self, model):
        """Record what the timed path produces, with no synchronize and no
        copy from the device: each ``decode_collect`` result (already on
        the host), and each greedy step's token and its log-probability as
        the step returns them (device tensors, read after the window)."""
        from stable_ts_tpu_torch.models.whisper import decoding
        self._calls, self._loops = [], []
        collect = model.decode_collect
        self._loop, self._select = loop, select = (decoding._greedy_loop,
                                                   decoding.select_from_aggregates)

        def recording_collect(pending, with_features=True):
            results = collect(pending, with_features=with_features)
            self._calls.append([(list(map(int, r.tokens)), float(r.avg_logprob),
                                 float(r.no_speech_prob)) for r in results])
            return results

        def recording_loop(*args, **kwargs):
            self._loops.append([])
            return loop(*args, **kwargs)

        def recording_select(agg, with_grammar=True):
            tok, lp = select(agg, with_grammar)
            self._loops[-1].append((tok, lp))
            return tok, lp
        model.decode_collect = recording_collect
        decoding._greedy_loop = recording_loop
        decoding.select_from_aggregates = recording_select

    def uninstall(self, model):
        from stable_ts_tpu_torch.models.whisper import decoding
        vars(model).pop('decode_collect', None)
        decoding._greedy_loop, decoding.select_from_aggregates = self._loop, self._select

    def trace_hooks(self, tracer, model):
        from stable_ts_tpu_torch.models.whisper import decoding
        tracer.span_on(decoding, '_greedy_loop', 'greedy_loop')
        tracer.step_on(decoding, 'decoder_step', 'decoder_step')
        tracer.span_on(model, 'embed_audio', 'embed_audio')

    def serve(self, model, req):
        first_call, first_loop = len(self._calls), len(self._loops)
        result = model.transcribe_batched(req['speech'].pcm,
                                          **self._options(req['sample_len']))
        with self.span('srt', sync=False):
            srt = result.to_srt_vtt()
        n_windows = math.ceil(len(req['speech'].pcm) / N_SAMPLES)
        batch = self.params['batch_size']
        calls, loops = self._calls[first_call:], self._loops[first_loop:]
        # group k decodes windows k * batch ... in one greedy loop; the
        # check finds a record that does not hold so (inf)
        rows = [(k, r, call[r]) for k, call in enumerate(calls)
                for r in range(min(batch, n_windows - k * batch))]
        whole = len(calls) == len(loops) == math.ceil(n_windows / batch)
        return dict(index=req['index'], audio_s=req['audio_s'],
                    seconds=req['seconds'], sample_len=req['sample_len'],
                    n_windows=n_windows, tokens=[t[2][0] for t in rows],
                    scores=[t[2][1:] for t in rows],
                    steps=[(loops[k], r) for k, r, _ in rows] if whole else None,
                    words=len(result.all_words()), srt_bytes=len(srt))

    def _logprobs(self, steps, served):
        """The log-probability the program's greedy step gave each served
        token, or None where the steps' tokens are not the served ones."""
        import torch
        if steps is None:
            return None
        loop, row = steps
        if len(loop) < len(served):
            return None
        toks = torch.stack([t for t, _ in loop[:len(served)]])[:, row].cpu().numpy()
        lps = torch.stack([lp for _, lp in loop[:len(served)]])[:, row].cpu().numpy()
        return lps.astype(np.float64) if list(toks) == list(served) else None

    def real_windows(self):
        return sum(r['n_windows'] for r in self.served)

    def useful_flops(self):
        total = 0.0
        for r in self.served:
            for toks in r['tokens']:
                n_text = sum(1 for t in toks if t < self.eot)
                total += (flops.encoder_window(self.dims)
                          + flops.greedy_window(self.dims, 3, len(toks))
                          + flops.timing_pass(self.dims, 3 + 1 + n_text + 1))
        return total

    # -- correctness ---------------------------------------------------------------------

    def sample(self):
        rng = self.rng('check')
        cands = [(k, w) for k, r in enumerate(self.served)
                 for w in range(min(r['n_windows'] - 1, len(r['tokens'])))]
        if not cands:
            return []
        longest = max(cands, key=lambda c: len(self.served[c[0]]['tokens'][c[1]]))
        k = min(self.params['check_windows'], len(cands))
        picked = {longest}
        for i in rng.permutation(len(cands)):
            if len(picked) >= k:
                break
            picked.add(cands[i])
        items = []
        for k_req in sorted({c[0] for c in picked}):
            r = self.served[k_req]
            speech = audio_mod.speech_like(r['seconds'], (self.seed, r['index']),
                                           self.device)
            pcm = speech.pcm.astype(np.float32) / 32768.0
            for k2, w in sorted(picked):
                if k2 == k_req:
                    toks = r['tokens'][w]
                    served = toks + [self.eot] if len(toks) < r['sample_len'] else toks
                    steps = r['steps'][w] if r['steps'] is not None else None
                    items.append(dict(audio=pcm[w * N_SAMPLES:(w + 1) * N_SAMPLES],
                                      prompt=None, tokens=toks,
                                      logprobs=self._logprobs(steps, served),
                                      sample_len=r['sample_len'],
                                      avg_logprob=r['scores'][w][0],
                                      no_speech_prob=r['scores'][w][1],
                                      where=(r['index'], w)))
        for r in self.served:        # the step records go with the program's state
            r['steps'] = None
        self._loops = []
        return items

    def check(self, judge, items):
        if not items:
            return dict(decode_logprob_gap=float('inf'))
        return judge.decode_gaps(items)

    def control(self, control_judge, items):
        return control_judge.control_outputs(items)
