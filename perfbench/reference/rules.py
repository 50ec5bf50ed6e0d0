"""What the reference judges the program's outputs by: Whisper's special
token layout, the greedy decode's filters, the gap of a served token below
the reference's best, and the log-probability a decode gives it.

Plain NumPy and PyTorch, written from openai/whisper's and stable-ts's
published rules; nothing here comes from the program.
"""
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

NON_SPEECH = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』') + (
    '<< >> <<< >>> -- --- -( -[ (\' (" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪'
).split()
MISC = set('♩♪♫♬♭♮♯')


def specials(n_base: int, num_languages: int) -> Dict[str, int]:
    """Whisper's special ids after ``n_base`` byte-level ids: EOT, SOT, the
    languages (English first), translate, transcribe, SOT-LM, SOT-prev,
    no-speech, no-timestamps, then the 1501 timestamps."""
    eot = n_base
    ids = dict(eot=eot, sot=eot + 1, en=eot + 2)
    at = eot + 2 + num_languages
    for name in ('translate', 'transcribe', 'sot_lm', 'sot_prev', 'no_speech',
                 'no_timestamps', 'ts_begin'):
        ids[name] = at
        at += 1
    return ids


def bpe(text: str, ranks: Dict[bytes, int]) -> List[int]:
    """Byte-level BPE of one pre-token: merge the adjacent pair of lowest
    rank until none is ranked."""
    parts = [bytes([b]) for b in text.encode('utf-8')]
    while len(parts) > 1:
        best = None
        for i in range(len(parts) - 1):
            r = ranks.get(parts[i] + parts[i + 1])
            if r is not None and (best is None or r < best[0]):
                best = (r, i)
        if best is None:
            break
        i = best[1]
        parts = parts[:i] + [parts[i] + parts[i + 1]] + parts[i + 2:]
    return [ranks[p] for p in parts]


def suppress_ids(ranks: Dict[bytes, int], sp: Dict[str, int]) -> List[int]:
    """``suppress_tokens='-1'``: the non-speech symbols that are one token
    (or the first token of a musical sign), plus the task and context
    specials and no-timestamps (a timestamped decode never samples it)."""
    out = set()
    for tok in (' -', " '"):
        ids = bpe(tok, ranks)
        if len(ids) == 1:
            out.add(ids[0])
    for sym in NON_SPEECH + sorted(MISC):
        for tok in (sym, ' ' + sym):
            ids = bpe(tok, ranks)
            if len(ids) == 1:
                out.add(ids[0])
            elif sym in MISC and ids:
                out.add(ids[0])
    out.update(sp[k] for k in ('transcribe', 'translate', 'sot', 'sot_prev',
                               'sot_lm', 'no_speech', 'no_timestamps'))
    return sorted(out)


def _step_rules(logits: torch.Tensor, history: Sequence[int], *, ts_begin: int,
                eot: int, suppress: Sequence[int], blank: Sequence[int],
                max_initial_ts: int = 50):
    """Per step i: (the logits with every id the deterministic rules forbid
    at -inf, the margin m by which the timestamps' summed probability
    beats the most probable text id). The rules: suppressed ids, the blank
    at step 0, the timestamp grammar (after a timestamp pair no timestamp,
    after a lone one no text), timestamps never decreasing, and the first
    token a timestamp of at most ``max_initial_ts``. ``history``: the
    tokens sampled before each step."""
    n, v = logits.shape
    device = logits.device
    base = torch.zeros(v, device=device, dtype=torch.float64)
    base[list(suppress)] = -math.inf
    max_ts = -1
    for i in range(n):
        allowed = base.clone()
        if i == 0:
            allowed[list(blank)] = -math.inf
        last = history[i - 1] if i >= 1 else -1
        penult = history[i - 2] if i >= 2 else -1
        last_ts = last >= ts_begin
        penult_ts = penult >= ts_begin or i < 2
        text_ban = last_ts and not penult_ts
        if last_ts and penult_ts:
            allowed[ts_begin:] = -math.inf
        if text_ban:
            allowed[:eot] = -math.inf
        if max_ts >= 0:
            floor = max_ts if text_ban else max_ts + 1
            allowed[ts_begin:ts_begin + floor] = -math.inf
        if i == 0:
            allowed[:ts_begin] = -math.inf
            allowed[ts_begin + max_initial_ts + 1:] = -math.inf
        lg = logits[i].double() + allowed
        lp = torch.log_softmax(lg, dim=-1)
        text_max = float(lp[:ts_begin].max())
        ts_lp = float(torch.logsumexp(lp[ts_begin:], dim=-1))
        m = ts_lp - text_max if math.isfinite(text_max) else math.inf
        yield lg, m
        if i < len(history) and history[i] >= ts_begin:
            max_ts = max(max_ts, history[i] - ts_begin)


def greedy_gaps(logits: torch.Tensor, history: Sequence[int],
                judged: Optional[Sequence[int]] = None, **rule_args) -> np.ndarray:
    """The gap of each judged token (default: the history itself, the
    tokens the program served) below the best the reference allows.

    logits: (n, V) the reference's logits before each of the ``n`` tokens.
    With A and B the best allowed text and timestamp logits and m the
    force-timestamp margin (:func:`_step_rules`), a text token t has the
    gap (A - l_t) + max(0, m), a timestamp min(max(A, B) - l_t, (B - l_t)
    + max(0, -m)): how far the reference is from choosing what was chosen.
    A token the rules forbid has the gap inf. Returns (n,) float64."""
    judged = history if judged is None else judged
    ts_begin = rule_args['ts_begin']
    gaps = np.zeros(len(judged))
    for i, (lg, m) in enumerate(_step_rules(logits, history, **rule_args)):
        tok = int(judged[i])
        lt = float(lg[tok])
        if not math.isfinite(lt):
            gaps[i] = math.inf
            continue
        a = float(lg[:ts_begin].max())
        b = float(lg[ts_begin:].max())
        if tok < ts_begin:
            gaps[i] = (a - lt) + max(0.0, m)
        else:
            gaps[i] = min(max(a, b) - lt, (b - lt) + max(0.0, -m))
    return gaps


def served_logprobs(logits: torch.Tensor, history: Sequence[int],
                    **rule_args) -> np.ndarray:
    """Each served token's log-probability as a greedy decode with these
    logits scores it: a text token (EOT among them) against every allowed
    id, since a decode that served text did not force a timestamp; a
    timestamp against the allowed timestamps when they win (margin m > 0),
    against every allowed id otherwise."""
    lo, _ = served_logprob_bounds(logits, history, tie=0.0, **rule_args)
    return lo


def served_logprob_bounds(logits: torch.Tensor, history: Sequence[int],
                          tie: float = 0.0, **rule_args):
    """(lo, hi): the interval of each served token's log-probability over
    the decisions a decode whose margin m lies within ``tie`` of these
    logits' could take. Only a served timestamp has two: scored against
    every allowed id (m <= 0) or against the timestamps alone (m > 0); at
    |m| <= tie either, else the one that the sign of m gives (tie 0: the
    sign, m = 0 counting as no force)."""
    ts_begin = rule_args['ts_begin']
    lo, hi = np.zeros(len(history)), np.zeros(len(history))
    for i, (lg, m) in enumerate(_step_rules(logits, history, **rule_args)):
        tok = int(history[i])
        every = float(lg[tok] - torch.logsumexp(lg, dim=-1))
        if tok < ts_begin:
            lo[i] = hi[i] = every
            continue
        alone = float(lg[tok] - torch.logsumexp(lg[ts_begin:], dim=-1))
        if abs(m) <= tie:
            lo[i], hi[i] = every, alone
        else:
            lo[i] = hi[i] = alone if m > 0 else every
    return lo, hi


def greedy_choices(logits: torch.Tensor, history: Sequence[int],
                   **rule_args) -> List[int]:
    """The token a greedy decode with these logits puts first at each
    step of ``history``: the best timestamp when the timestamps win,
    otherwise the best allowed id."""
    ts_begin = rule_args['ts_begin']
    out = []
    for lg, m in _step_rules(logits, history, **rule_args):
        out.append(int(ts_begin + int(lg[ts_begin:].argmax())) if m > 0
                   else int(lg.argmax()))
    return out


def initial_tokens(sp: Dict[str, int], prompt: Optional[Sequence[int]],
                   n_text_ctx: int = 448) -> List[int]:
    """[SOT-prev, prompt tail] + SOT, English, transcribe."""
    seq = [sp['sot'], sp['en'], sp['transcribe']]
    if prompt:
        seq = [sp['sot_prev']] + list(prompt)[-(n_text_ctx // 2 - 1):] + seq
    return seq
