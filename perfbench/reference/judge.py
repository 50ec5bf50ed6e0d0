"""The comparisons that decide ``correct``.

:class:`Judge` holds the reference model (f32, or the control's lower
precision) and the rules, and reads the program's outputs:

a greedy decode (the window's audio, its prompt, the tokens the program
served and the log-probability its decode gave each): how far each served
token's log-probability lies from the reference's
(``rules.served_logprob_bounds``), the no-speech probability, and the gap
of a served token below the reference's best (``rules.greedy_gaps``).

The same Judge built as the control produces what the lower precision
would have served on the same inputs (:meth:`control_outputs`), to be read
by the f32 Judge.
"""
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import rules
from .whisper import N_SAMPLES, Reference, log_mel


# A served timestamp is scored either way where the reference's force
# margin lies within this many nats of nought: about six times the widest
# gap of a served token below the reference's best in the program's runs.
TIE = 0.25


def num_languages(dims: dict) -> int:
    return dims['n_vocab'] - 51765 - int(dims['n_vocab'] >= 51865)


class Judge:
    def __init__(self, sd, dims: dict, ranks: Dict[bytes, int], device, weight_format: Optional[str] = None,
                 kv_bits: Optional[int] = None):
        self.dims = dims
        self.device = device
        self.ref = Reference(sd, dims, device, weight_format, kv_bits)
        self.sp = rules.specials(len(ranks), num_languages(dims))
        self.eot, self.ts_begin = self.sp['eot'], self.sp['ts_begin']
        self.suppress = rules.suppress_ids(ranks, self.sp)
        self.blank = rules.bpe(' ', ranks) + [self.eot]

    def _encode(self, audio: Sequence[np.ndarray]) -> torch.Tensor:
        x = torch.stack([torch.from_numpy(np.asarray(a, np.float32)[:N_SAMPLES])
                         if len(a) >= N_SAMPLES else torch.nn.functional.pad(
                             torch.from_numpy(np.asarray(a, np.float32)),
                             (0, N_SAMPLES - len(a)))
                         for a in audio]).to(self.device)
        return self.ref.encode(log_mel(x, self.dims['n_mels']))

    def _step_logits(self, xa, prompt, tokens):
        """(the reference's logits before each of ``tokens``, its
        log-probability of no-speech after SOT over the whole vocabulary)."""
        init = rules.initial_tokens(self.sp, prompt, self.dims['n_text_ctx'])
        seq = init + list(tokens[:-1])
        t = torch.tensor([seq], device=self.device)
        logits = self.ref.decode(t, xa[None])
        sot = init.index(self.sp['sot'])
        no_speech = torch.log_softmax(logits[0, sot].double(), dim=-1)[
            self.sp['no_speech']]
        return logits[0, len(init) - 1:], float(no_speech)

    def _rule_args(self):
        return dict(ts_begin=self.ts_begin, eot=self.eot,
                    suppress=self.suppress, blank=self.blank)

    # -- greedy decoding ------------------------------------------------------------------

    def _served(self, w: dict) -> List[int]:
        """The window's served tokens, with the EOT the program chose when
        it stopped before ``sample_len``."""
        toks = list(w['tokens'])
        if len(toks) < w['sample_len']:
            toks.append(self.eot)
        return toks

    def _windows_logits(self, windows: List[dict], block: int):
        for i in range(0, len(windows), block):
            chunk = windows[i:i + block]
            xa = self._encode([w['audio'] for w in chunk])
            for w, feats in zip(chunk, xa):
                served = self._served(w)
                yield (w, served) + self._step_logits(feats, w['prompt'], served)

    def decode_gaps(self, windows: List[dict], block: int = 4) -> Dict[str, float]:
        """windows: dicts of ``audio`` (f32 samples of the window), ``prompt``
        (token list or None), ``tokens`` (what the program served, cut at
        its EOT), ``sample_len``, the program's ``avg_logprob`` and
        ``no_speech_prob``, and ``logprobs``, the log-probability the
        program's decode step gave each served token (EOT included); a
        ``judged`` list, one token a served position, is judged in place of
        the served tokens for the gaps below the best.

        Compared: ``decode_logprob_gap``, the widest distance of a
        log-probability the program's decode answered with from the
        reference's: the larger of ``token_logprob_gap``, over the served
        tokens, where a timestamp may be scored either way when the
        reference's force margin lies within ``TIE`` of nought
        (:func:`rules.served_logprob_bounds`), and ``no_speech_gap``, over
        the windows' log no-speech probabilities. Logged: those two;
        ``avg_logprob_gap``, the widest difference of the window's average
        log-probability, scored by the sign of the reference's margin;
        ``ties``, the served timestamps scored either way; the widest and
        the mean gap of a judged token below the reference's best; the
        count of judged tokens."""
        widest = total = lp_gap = ns_gap = tok_gap = 0.0
        count = ties = 0
        for w, served, lg, no_speech in self._windows_logits(windows, block):
            args = self._rule_args()
            gaps = rules.greedy_gaps(lg, served, **args, judged=w.get('judged'))
            widest = max(widest, float(gaps.max()))
            total += float(gaps.sum())
            count += len(gaps)
            lo, hi = rules.served_logprob_bounds(lg, served, tie=TIE, **args)
            ties += int(np.count_nonzero(hi > lo))
            mine = w.get('logprobs')
            if mine is None or len(mine) != len(served):
                tok_gap = math.inf
            else:
                mine = np.asarray(mine, np.float64)
                tok_gap = max(tok_gap, float(np.max(np.maximum(lo - mine, mine - hi))))
            avg = rules.served_logprobs(lg, served, **args).sum() / (len(w['tokens']) + 1)
            lp_gap = max(lp_gap, abs(avg - w['avg_logprob']))
            ns_gap = max(ns_gap, abs(np.log(max(w['no_speech_prob'], 1e-300))
                                     - no_speech))
        return dict(decode_logprob_gap=max(tok_gap, ns_gap), token_logprob_gap=tok_gap,
                    no_speech_gap=ns_gap, avg_logprob_gap=lp_gap, ties=ties,
                    logit_gap=widest, mean_gap=total / max(count, 1), tokens=count)

    def control_outputs(self, windows: List[dict], block: int = 4) -> List[dict]:
        """The windows with what this (lower-precision) reference computes
        in the program's place on the same inputs: the token it puts first
        at each served position, the log-probability its decode step would
        give each served token, their average, and its no-speech
        probability."""
        out = []
        for w, served, lg, no_speech in self._windows_logits(windows, block):
            args = self._rule_args()
            lps = rules.served_logprobs(lg, served, **args)
            out.append(dict(w, judged=rules.greedy_choices(lg, served, **args),
                            logprobs=lps,
                            avg_logprob=float(lps.sum() / (len(w['tokens']) + 1)),
                            no_speech_prob=float(np.exp(no_speech))))
        return out
