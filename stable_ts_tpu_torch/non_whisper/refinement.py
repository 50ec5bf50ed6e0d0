"""Engine-agnostic timestamp refinement by mute-and-bisect.

Behavioral counterpart of stable-ts stable_whisper/non_whisper/refinement.py
(Refiner:13): sharpen word start/end timestamps by muting audio around each
boundary and bisecting on the token-probability response. Words are packed
into <=30-s / <=max_inference_tokens batches; even words are muted in row 0
and odd words in row 1 so one batch-of-2 forward refines every word in the
span simultaneously; acceptance tests use absolute/relative/relative-change
probability drops, a probability floor, and best-token-rank changes.

``inference_func(audio[2, T], tokens) -> probs[2, n_tokens(, vocab)]``.

TPU redesign (SURVEY §7 P5), two layers:

- :class:`_SpanBisect` holds each span's bisection state as numpy ARRAYS
  (lo/hi/mid boundary intervals, accept/fail history, last committed mid)
  and advances every word of the span in one vectorized update per probe —
  there is no per-word Python state machine.
- ``_span_machine`` wraps a span in a generator that *yields* its probe
  request; with a ``batch_inference_func`` every pending span's probe is
  evaluated in ONE batched forward per bisection round (lockstep), instead
  of a sequential per-span loop of batch-2 forwards. Sequential semantics
  are bit-identical (tests/test_refine_parity.py drives this refiner and
  the reference's against the same fake backend and compares timestamps).
"""
import copy
from typing import Callable, List, Optional, Union

import numpy as np

from ..audio import prep_audio
from ..options import AllOptions
from ..result import WhisperResult, WordTiming


class MutedSpanProbe:
    """A probe request in INTERVAL form: the span's clean audio plus a list
    of zeroed intervals ``[zero_lo_i, zero_hi_i)`` on row ``rows_i``.

    A backend that advertises ``accepts_intervals = True`` on its
    ``batch_inference_func`` receives this instead of materialized (2, T)
    rows and can rebuild the muted audio ON DEVICE: the clean span uploads
    once per step and each bisection round ships only these few int32s —
    instead of re-uploading every muted row every round (~30 MB/round at
    16 rows of 30 s audio, the dominant refine cost on a thin host link).
    The row state is always "clean audio except zeroed positions", and
    every host write's effect on the zero set is exactly a range union
    (zero) or range difference (restore) — :class:`_IntervalSet` mirrors
    those ops per row, so the emitted disjoint intervals reconstruct the
    muted rows byte-for-byte under ANY write pattern (including the quirky
    token-row mapping's cross-word writes).
    """

    __slots__ = ('clean', 'rows', 'zero_lo', 'zero_hi', 'epoch')

    def __init__(self, clean: np.ndarray, rows: np.ndarray,
                 zero_lo: np.ndarray, zero_hi: np.ndarray, epoch: int = 0):
        self.clean = clean        # (T,) float32, shared across a step
        self.rows = rows          # (m,) int — target row of each interval
        self.zero_lo = zero_lo    # (m,) int64 snapshot
        self.zero_hi = zero_hi
        # step epoch: bumped by the Refiner per span-set build; backends key
        # their device-side clean-audio caches on THIS (a new epoch's first
        # round carries every span of its group) rather than on object
        # identity, so a protocol violation surfaces loudly instead of as a
        # silent rebuild-every-round performance cliff (ADVICE r4)
        self.epoch = epoch


class _IntervalSet:
    """Sorted disjoint [a, b) intervals with O(n)-per-op union/difference —
    the zero-set of one audio row."""

    __slots__ = ('iv',)

    def __init__(self):
        self.iv = []

    def add(self, a: int, b: int):
        if a >= b:
            return
        keep = []
        for x, y in self.iv:
            if y < a or b < x:          # strictly disjoint (touching merges)
                keep.append((x, y))
            else:
                a = min(a, x)
                b = max(b, y)
        keep.append((a, b))
        keep.sort()
        self.iv = keep

    def remove(self, a: int, b: int):
        if a >= b:
            return
        keep = []
        for x, y in self.iv:
            if y <= a or x >= b:
                keep.append((x, y))
                continue
            if x < a:
                keep.append((x, a))
            if y > b:
                keep.append((b, y))
        keep.sort()
        self.iv = keep


class _SpanBisect:
    """Vectorized mute-and-bisect state for ONE span of words.

    Per-word arrays: ``lo``/``hi``/``mid`` bound the boundary's search
    interval in samples (start step: [earliest allowed start, word end];
    end step: [word start, latest allowed end]); ``done`` marks words whose
    interval collapsed below the sample precision; ``ever_fail``/``ever_ok``
    record which branch outcomes occurred (the commit rule needs them);
    ``last_good`` is the most recent probe position whose best-token rank
    held (-1 = never).

    Probe audio layout: even words are muted in row 0, odd words in row 1,
    so one (2, T) forward measures every word's response at once.
    """

    def __init__(self, refiner: 'Refiner', span, is_end: bool):
        words, lower, upper, edge_mask = span
        r = self.refiner = refiner
        self.is_end = is_end
        self.words: List[WordTiming] = list(words)
        n = len(self.words)

        self.time_offset = float(lower[0])
        a = round(self.time_offset * r.sample_rate)
        b = round(float(upper[-1]) * r.sample_rate)
        self.clean = r._audio[a:b + 1]              # unmuted source (1-D)
        # interval mode (MutedSpanProbe): the backend rebuilds muted rows
        # on device, so the (2, T) copies and per-round writes never happen
        self.materialize = not r._emit_intervals
        self.audio = (np.repeat(self.clean[None], 2, axis=0)
                      if self.materialize else None)

        word_starts = r.second_to_sample([w.start for w in self.words],
                                         self.time_offset)
        word_ends = r.second_to_sample([w.end for w in self.words],
                                       self.time_offset)
        if is_end:
            self.lo, self.hi = word_starts, r.second_to_sample(
                upper, self.time_offset)
            self.anchor = word_ends       # current boundary position
        else:
            self.lo = r.second_to_sample(lower, self.time_offset)
            self.hi = word_ends
            self.anchor = word_starts
        self.mid = self.lo + ((self.hi - self.lo) / 2).round().astype(np.int32)

        self.text_tokens = [t for w in self.words for t in w.tokens]
        self.word_tokens = [list(w.tokens) for w in self.words]
        self.prob_indices = [i % 2 for i, w in enumerate(self.words)
                             for _ in w.tokens]
        # NOTE: the bisect rounds index the per-TOKEN row list by WORD
        # index (reference refinement.py:425 does the same) — for
        # multi-token words this picks the row of the word owning token
        # #idx, not word #idx's own row. Kept for exactness; the parity
        # suite pins it.
        self.rows = np.asarray(self.prob_indices[:n], np.int32)

        self.done = np.less([w.probability for w in self.words],
                            r.prob_threshold)
        self.done |= np.array([w.duration == 0 for w in self.words])
        if not r.word_level:
            self.done[edge_mask != (2 if is_end else 1)] = True

        self.ever_fail = np.zeros(n, bool)
        self.ever_ok = np.zeros(n, bool)
        self.last_good = np.full(n, -1, np.int64)
        self.base_probs = self.base_ranks = self.prev_probs = None
        self.epoch = getattr(r, '_probe_epoch', 0)

        # Interval mode: the zero-set of each row, mirrored through exactly
        # the same add (zero write) / remove (restore write) ranges the
        # materialized path applies, so the probe's intervals reconstruct
        # the muted rows byte-for-byte.
        self.mutes = None if self.materialize else (_IntervalSet(),
                                                    _IntervalSet())

        # initial mutes: silence everything OUTSIDE each live word's span
        # on its row (end step: from the word's end to the next word's
        # probe mid; start step: from the previous word's probe mid to the
        # word's start)
        for idx in np.flatnonzero(~self.done):
            row = idx % 2
            if is_end:
                stop = (self.clean.shape[-1] if idx == n - 1
                        else self.mid[idx + 1])
                a, b = int(self.anchor[idx]), int(stop)
            else:
                begin = 0 if idx == 0 else self.mid[idx - 1]
                a, b = int(begin), int(self.anchor[idx])
            if self.materialize:
                self.audio[row, a:b] = 0
            else:
                self.mutes[row].add(a, b)

    def request(self):
        """The probe: (audio(2, T), text_tokens, word_tokens, prob_indices).

        In interval mode the first element is a :class:`MutedSpanProbe`
        (clean audio + the rows' disjoint mute intervals) instead of
        materialized rows."""
        if self.materialize:
            audio = self.audio
        else:
            rows, los, his = [], [], []
            for row, ms in enumerate(self.mutes):
                for a, b in ms.iv:
                    rows.append(row)
                    los.append(a)
                    his.append(b)
            audio = MutedSpanProbe(
                self.clean, np.asarray(rows, np.int64),
                np.asarray(los, np.int64), np.asarray(his, np.int64),
                epoch=self.epoch)
        return audio, self.text_tokens, self.word_tokens, self.prob_indices

    def set_baseline(self, probs, ranks):
        """Record the unprobed response, then mute up to each word's first
        probe position (anchor..mid / mid..anchor)."""
        self.base_probs = np.asarray(probs, np.float64)
        self.prev_probs = self.base_probs
        self.base_ranks = np.asarray(ranks)
        for idx in np.flatnonzero(~self.done):
            row = idx % 2
            if self.is_end:
                a, b = int(self.mid[idx]), int(self.anchor[idx])
            else:
                a, b = int(self.anchor[idx]), int(self.mid[idx])
            if self.materialize:
                self.audio[row, a:b] = 0
            else:
                self.mutes[row].add(a, b)

    @property
    def unfinished(self) -> bool:
        return not self.done.all()

    def apply_round(self, probs, ranks):
        """One vectorized bisection round over every live word."""
        r = self.refiner
        probs = np.asarray(probs, np.float64)
        ranks = np.asarray(ranks)
        act = ~self.done

        with np.errstate(divide='ignore', invalid='ignore'):
            drop = self.base_probs - probs
            rel_drop = drop / self.base_probs
            accel = (self.prev_probs - probs) / self.prev_probs
        self.prev_probs = probs

        rank_worse = self.base_ranks > ranks
        fail = (drop > r.abs_prob_decrease) | (rel_drop > r.rel_prob_decrease)
        if r.rel_rel_prob_decrease is not None:
            fail = fail | (accel > r.rel_rel_prob_decrease)
        fail = fail | (probs < r.prob_threshold) | rank_worse

        # shrink: a failed probe keeps the boundary nearer the word (end
        # step raises lo, start step lowers hi); success moves it outward
        lo_moves = act & (fail if self.is_end else ~fail)
        hi_moves = act & ~lo_moves
        self.lo = np.where(lo_moves, self.mid, self.lo)
        self.hi = np.where(hi_moves, self.mid, self.hi)
        self.ever_fail |= act & fail
        self.ever_ok |= act & ~fail

        half = ((self.hi - self.lo) / 2).round().astype(np.int64)
        collapsed = act & (half < r.sample_precision)
        live = act & ~collapsed
        new_mid = (self.lo + half).astype(np.int32)

        self.done |= collapsed
        for idx in np.flatnonzero(collapsed):
            self._commit(idx)

        for idx in np.flatnonzero(live):
            row = self.rows[idx]
            m = int(new_mid[idx])
            if fail[idx]:
                # went too far: restore the span between the kept bound
                # and the new probe position
                a, b = ((int(self.lo[idx]), m) if self.is_end
                        else (m, int(self.hi[idx])))
                if self.materialize:
                    self.audio[row, a:b] = self.clean[a:b]
                else:
                    self.mutes[row].remove(a, b)
            else:
                a, b = ((m, int(self.hi[idx])) if self.is_end
                        else (int(self.lo[idx]), m))
                if self.materialize:
                    self.audio[row, a:b] = 0
                else:
                    self.mutes[row].add(a, b)

        self.mid = np.where(live, new_mid, self.mid)
        self.last_good = np.where(live & ~rank_worse, new_mid, self.last_good)
        self.base_probs = np.where(live, probs, self.base_probs)

    def _commit(self, idx: int):
        """Write the refined boundary back to the word (collapse time)."""
        if self.last_good[idx] == -1:
            return
        r = self.refiner
        word = self.words[idx]
        new_ts = round(
            self.time_offset + float(self.last_good[idx]) / r.sample_rate, 3)
        if self.ever_fail[idx] and not self.ever_ok[idx]:
            # every probe failed: only accept a TIGHTENING move
            if self.is_end:
                if new_ts <= word.end:
                    return
            elif new_ts >= word.start:
                return
        old_ts = word.end if self.is_end else word.start
        if self.is_end:
            word.end = new_ts
        else:
            word.start = new_ts
        if r.options.progress.verbose and old_ts != new_ts:
            info = (f'[Word="{word.word}"] [Segment ID: {word.segment_id}] '
                    f'[Word ID: {word.id}]')
            print(f'{"End" if self.is_end else "Start"}: '
                  f'{old_ts} -> {new_ts}  {info}')


class Refiner:

    def __init__(
            self,
            inference_func: Callable,
            sample_rate: int = 16000,
            max_segment_length: Union[int, str] = '30s',
            max_inference_tokens: int = 100,
            *,
            steps: str = 'se',
            rel_prob_decrease: float = .03,
            abs_prob_decrease: float = .05,
            rel_rel_prob_decrease: Optional[float] = None,
            prob_threshold: float = .5,
            rel_dur_change: Optional[float] = .5,
            abs_dur_change: Optional[float] = None,
            word_level: bool = True,
            precision: Optional[float] = None,
            batch_inference_func: Optional[Callable] = None,
            **options,
    ):
        if not steps:
            steps = 'se'
        invalid_steps = steps.replace('s', '').replace('e', '')
        if invalid_steps:
            raise ValueError(f'Invalid step(s): {", ".join(invalid_steps)}')
        if precision is None:
            precision = 0.1
        if isinstance(max_segment_length, str):
            if not max_segment_length.endswith('s'):
                raise ValueError('string ``max_segment_length`` must end with "s"')
            self.max_segment_seconds = float(max_segment_length[:-1])
        else:
            self.max_segment_seconds = max_segment_length / sample_rate

        self.options = AllOptions(options, silence=False, align=False)
        self.steps = steps
        self.precision = precision
        self.sample_rate = sample_rate
        self.max_inference_tokens = max_inference_tokens
        self.sample_precision = max(round(self.precision * self.sample_rate), 2)
        self.inference_func = inference_func
        self.batch_inference_func = batch_inference_func
        # backends advertising accepts_intervals receive MutedSpanProbe
        # requests (mute intervals instead of materialized audio rows) —
        # the muted rows are then rebuilt on device and each bisection
        # round ships a few int32s instead of every row's samples
        self._emit_intervals = bool(getattr(batch_inference_func,
                                            'accepts_intervals', False))
        self.rel_prob_decrease = rel_prob_decrease
        self.abs_prob_decrease = abs_prob_decrease
        self.rel_rel_prob_decrease = rel_rel_prob_decrease
        self.prob_threshold = prob_threshold
        self.rel_dur_change = rel_dur_change
        self.abs_dur_change = abs_dur_change
        self.word_level = word_level
        self._audio = np.zeros(0, np.float32)

    # -- entry point ------------------------------------------------------------------

    def refine(self, audio, result: WhisperResult, inplace: bool = True,
               encode: Optional[Callable] = None, **options) -> WhisperResult:
        """Refine ``result``'s timestamps against ``audio``."""
        if result:
            if not result.has_words:
                raise RuntimeError('cannot refine result with missing word-timestamps')
            if not all(word.tokens for word in result.all_words()):
                if encode is None:
                    raise RuntimeError('result must have tokens or provide '
                                       'tokenization function to ``encode``')
                for word in result.all_words():
                    word.tokens = encode(word.word)
        if not inplace:
            result = copy.deepcopy(result)

        self._audio = prep_audio(
            audio,
            denoiser=self.options.pre.denoiser,
            denoiser_options=self.options.pre.denoiser_options,
            only_voice_freq=self.options.pre.only_voice_freq,
        )
        for k in list(options.keys()):
            if hasattr(self, k):
                setattr(self, k, options.pop(k))
        self.options.update(options)

        from ..utils import make_progress_bar, progress_update
        total = round(self._audio.shape[-1] / self.sample_rate, 2)
        self._pbar = make_progress_bar(total, 'Refine',
                                       self.options.progress.verbose)
        self._pbar_base = 0.0
        try:
            for i, step in enumerate(self.steps):
                self._pbar_base = total * i / len(self.steps)
                self._refine(result, step)
                progress_update(self._pbar, total * (i + 1) / len(self.steps))
        finally:
            self._pbar.close()
            self._pbar = None
        result.reassign_ids()
        return result

    # -- batching -----------------------------------------------------------------------

    def _movement_bounds(self, all_words: List[WordTiming],
                         total_duration: float):
        """Per-word (earliest start, latest end) the refinement may reach.

        Three caps, combined elementwise: the configured absolute/relative
        duration change, the neighboring words' boundaries, and +-14.5 s
        (half an inference window) from the word's current span.
        """
        starts = np.array([w.start for w in all_words], np.float64)
        ends = np.array([w.end for w in all_words], np.float64)
        # w.duration, not ends - starts: the property rounds to ms, and the
        # relative-change cap must use the same value to stay bit-identical
        durs = np.array([w.duration for w in all_words], np.float64)

        lower = np.zeros(len(all_words), np.float64)
        if self.abs_dur_change is not None:
            lower = np.maximum(lower, starts - self.abs_dur_change)
        if self.rel_dur_change is not None:
            lower = np.maximum(lower, starts - durs * self.rel_dur_change)
        prev_floor = np.maximum(ends - 14.5, 0)
        prev_floor[1:] = np.maximum(prev_floor[1:], ends[:-1])
        prev_floor[0] = 0
        lower = np.maximum(lower, prev_floor)

        upper = np.full(len(all_words), total_duration, np.float64)
        if self.abs_dur_change is not None:
            upper = np.minimum(upper, ends + self.abs_dur_change)
        if self.rel_dur_change is not None:
            upper = np.minimum(upper, ends + durs * self.rel_dur_change)
        next_ceil = np.minimum(starts + 14.5, total_duration)
        next_ceil[:-1] = np.minimum(next_ceil[:-1], starts[1:])
        next_ceil[-1] = total_duration
        upper = np.minimum(upper, next_ceil)
        return lower, upper

    def curr_segments(self, result: WhisperResult, total_duration: float):
        """Yield (words, min_starts, max_ends, edge_mask) spans, each
        bounded by ``max_segment_seconds`` of reachable audio and
        ``max_inference_tokens`` tokens."""
        all_words = result.all_words()
        if not all_words:
            return
        lower, upper = self._movement_bounds(all_words, total_duration)
        masks = []
        for seg in result.segments:
            if not seg.words:
                continue
            m = np.zeros(len(seg.words), np.int64)
            m[-1] = 2
            m[0] = 1  # a single-word segment counts as a segment START
            masks.append(m)
        edge_mask = np.concatenate(masks)

        first = 0       # index of the open span's first word
        used_tokens = 0
        for i, w in enumerate(all_words):
            if (upper[i] - lower[first] > self.max_segment_seconds
                    or used_tokens + len(w.tokens) > self.max_inference_tokens):
                if i > first:
                    yield (all_words[first:i], lower[first:i], upper[first:i],
                           edge_mask[first:i])
                first = i
                used_tokens = 0
            used_tokens += len(w.tokens)
        yield (all_words[first:], lower[first:], upper[first:],
               edge_mask[first:])

    def second_to_sample(self, timestamps, offset: Optional[float] = None
                         ) -> np.ndarray:
        timestamps = np.asarray(timestamps)
        return ((timestamps - offset) * self.sample_rate).round().astype(np.int32)

    # -- probability probing ---------------------------------------------------------------

    def get_prob(self, audio_segment: np.ndarray, text_tokens: List[int],
                 word_tokens: List[List[int]], prob_indices: List[int],
                 is_end_ts: bool):
        """One batched forward -> (per-word probs, per-word best-token ranks)."""
        token_probs = np.asarray(self.inference_func(audio_segment, text_tokens))
        return self._probs_and_ranks(token_probs, text_tokens, word_tokens,
                                     prob_indices, is_end_ts)

    def _probs_and_ranks(self, token_probs: np.ndarray,
                         text_tokens: List[int],
                         word_tokens: List[List[int]],
                         prob_indices: List[int], is_end_ts: bool):
        """Reduce raw inference output to one (prob, rank) per word.

        The per-word representative token is the word's LAST token for the
        end step and its FIRST token for the start step; each token's value
        is read from the batch row that had that word's mute pattern.
        """
        if token_probs.shape[0] != 2:
            raise RuntimeError(
                f'expected dim 0 to be length of 2 but got {token_probs.shape[0]}')
        if token_probs.shape[1] != len(text_tokens):
            raise RuntimeError(
                f'expected dim 1 to be length of {len(text_tokens)} '
                f'but got {token_probs.shape[1]}')
        if token_probs.ndim not in (2, 3):
            raise RuntimeError('expected inference_func output to have 2 or 3 '
                               f'dimensions but got {token_probs.ndim}')
        rows = np.asarray(prob_indices)
        cols = np.arange(len(text_tokens))
        bounds = np.pad(np.cumsum([len(t) for t in word_tokens]), (1, 0))
        pick = (bounds[1:] - 1) if is_end_ts else bounds[:-1]

        if token_probs.ndim == 2:
            per_token = token_probs[rows, cols]
            word_ranks = np.zeros(len(word_tokens), np.int64)
        else:
            tokens = np.asarray(text_tokens)
            dist = token_probs[rows, cols]                  # (n_tok, vocab)
            per_token = dist[cols, tokens]
            order = np.argsort(dist, axis=-1)
            ranks = np.argmax(order == tokens[:, None], axis=-1)
            word_ranks = ranks[pick]
        return per_token[pick], word_ranks

    # -- the bisection loop -----------------------------------------------------------------------

    def _refine(self, result: WhisperResult, step: str):
        total_duration = round(self._audio.shape[-1] / self.sample_rate, 3)
        # new span set -> new probe epoch (see MutedSpanProbe.epoch)
        self._probe_epoch = getattr(self, '_probe_epoch', 0) + 1
        machines = [
            self._span_machine(span, step, total_duration)
            for span in self.curr_segments(result, total_duration)
        ]
        if self.batch_inference_func is None:
            for machine in machines:
                self._drive_sequential(machine, step)
        else:
            self._drive_lockstep(machines, step)

    def _drive_sequential(self, machine, step: str):
        is_end_ts = step == 'e'
        try:
            request = next(machine)
            while True:
                audio_segment, text_tokens, word_tokens, prob_indices = request
                reply = self.get_prob(audio_segment, text_tokens, word_tokens,
                                      prob_indices, is_end_ts)
                request = machine.send(reply)
        except StopIteration:
            pass

    def _drive_lockstep(self, machines, step: str):
        """Advance every span one bisection round per batched forward.

        When the backend exposes ``launch``/``collect`` (an async split of
        its batch call: launch dispatches the forward and returns a handle,
        collect materializes its results), spans are partitioned into two
        independent groups whose rounds INTERLEAVE — while group A's round
        computes on device, the host downloads group B's previous results,
        applies its bisection updates, and dispatches its next round. Span
        bisections are independent, so each span sees exactly the probe
        sequence of the unpipelined path (pinned by
        tests/test_refine_pipeline.py); only host/transfer latency leaves
        the critical path.
        """
        import os
        launch = getattr(self.batch_inference_func, 'launch', None)
        collect = getattr(self.batch_inference_func, 'collect', None)
        # STABLE_TS_TPU_REFINE_PIPE=0 folds every span into ONE round group
        # (no host/device overlap, but each round is a single fatter batch —
        # wins when the per-round host update is tiny, as on the fused path)
        split = os.environ.get('STABLE_TS_TPU_REFINE_PIPE', '1') != '0'
        groups = ([machines] if launch is None or collect is None
                  or not split or len(machines) < 2
                  else self._split_pipeline(machines))
        if len(groups) == 1:
            self._drive_group(groups[0], step)
            return

        is_end_ts = step == 'e'
        live = []   # [group id, active list, pending handle] per group
        for gi, ms in enumerate(groups):
            active = []
            for machine in ms:
                try:
                    active.append((machine, next(machine)))
                except StopIteration:
                    pass
            if active:
                live.append([gi, active, launch(
                    [(req[0], req[1]) for _, req in active], key=gi)])
        while live:
            nxt_live = []
            for entry in live:
                gi, active, handle = entry
                raw_list = collect(handle)
                nxt = []
                for (machine, req), raw in zip(active, raw_list):
                    reply = self._reduce_reply(raw, req, is_end_ts)
                    try:
                        nxt.append((machine, machine.send(reply)))
                    except StopIteration:
                        pass
                if nxt:
                    entry[1] = nxt
                    entry[2] = launch([(req[0], req[1]) for _, req in nxt],
                                      key=gi)
                    nxt_live.append(entry)
            live = nxt_live

    @staticmethod
    def _split_pipeline(machines):
        """Two groups sized to pack the backend's power-of-2 row buckets
        tightly: the second group is the largest power of 2 below n, the
        first is the remainder (e.g. 6 -> 2+4, 8 -> 4+4, 5 -> 1+4)."""
        n = len(machines)
        g2 = 1 << ((n - 1).bit_length() - 1)
        return [machines[:n - g2], machines[n - g2:]]

    def _reduce_reply(self, raw, req, is_end_ts: bool):
        _, text_tokens, word_tokens, prob_indices = req
        if isinstance(raw, tuple):
            # device-side contract: (probs (2, n), ranks (2, n)) of
            # the REALIZED tokens, already reduced over the vocab on
            # device (the whisper glue's batch_func) — only the
            # per-word picking remains for the host
            return self._pick_reduced(raw, text_tokens, word_tokens,
                                      prob_indices, is_end_ts)
        return self._probs_and_ranks(np.asarray(raw), text_tokens,
                                     word_tokens, prob_indices, is_end_ts)

    def _drive_group(self, machines, step: str):
        is_end_ts = step == 'e'
        active = []
        for machine in machines:
            try:
                active.append((machine, next(machine)))
            except StopIteration:
                pass
        while active:
            raw_list = self.batch_inference_func(
                [(req[0], req[1]) for _, req in active])
            nxt = []
            for (machine, req), raw in zip(active, raw_list):
                reply = self._reduce_reply(raw, req, is_end_ts)
                try:
                    nxt.append((machine, machine.send(reply)))
                except StopIteration:
                    pass
            active = nxt

    def _pick_reduced(self, raw, text_tokens, word_tokens, prob_indices,
                      is_end_ts: bool):
        """Per-word picking for batch replies whose vocab reduction already
        ran on device: ``raw`` = (probs (2, n_tokens), ranks (2, n_tokens))
        of the realized tokens. Same picking as :meth:`_probs_and_ranks`."""
        per_token, ranks = (np.asarray(r) for r in raw)
        for arr in (per_token, ranks):
            if arr.shape != (2, len(text_tokens)):
                raise RuntimeError(f'expected reduced reply of shape '
                                   f'(2, {len(text_tokens)}) but got '
                                   f'{arr.shape}')
        rows = np.asarray(prob_indices)
        cols = np.arange(len(text_tokens))
        bounds = np.pad(np.cumsum([len(t) for t in word_tokens]), (1, 0))
        pick = (bounds[1:] - 1) if is_end_ts else bounds[:-1]
        return per_token[rows, cols][pick], ranks[rows, cols][pick]

    def _span_machine(self, span, step: str, total_duration: float):
        """Generator shell around :class:`_SpanBisect`: yields probe
        requests, feeds replies into the vectorized state."""
        state = _SpanBisect(self, span, step == 'e')
        state.set_baseline(*(yield state.request()))
        while state.unfinished:
            state.apply_round(*(yield state.request()))

        from ..utils import progress_update
        pbar = getattr(self, '_pbar', None)
        if pbar is not None:
            # each step owns an equal slice of the bar (reference
            # refinement.py:181-193's _pbar_step rule)
            progress_update(pbar, self._pbar_base
                            + min(state.words[-1].end, total_duration)
                            / len(self.steps))
        if self.options.progress.progress_callback is not None:
            self.options.progress.progress_callback(
                min(state.words[-1].end, total_duration), total_duration)
