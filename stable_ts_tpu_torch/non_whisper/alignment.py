"""Engine-agnostic forced alignment with stabilizing fallback.

Behavioral counterpart of stable-ts stable_whisper/non_whisper/alignment.py
(Aligner:58): align known text to audio using any backend that can produce
per-word timestamps for a short audio segment. The subtle part — preserved
exactly — is the fallback loop (:937-1006): after each pass, keep words up to
the last nonzero-duration word, clamp over-long words by a local
(``word_dur_factor`` x median) and global (``max_word_dur``) duration cap,
requeue the rest, and re-seek to the last good timestamp.

``inference_func(audio_segment: np.ndarray, word_tokens: List[WordToken])``
must return a list of dicts with word/start/end(/probability) covering at
least the given words in order.
"""
import copy
import re
import warnings
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from ..audio.loader import AudioLoader
from ..defaults import (get_append_punctuations, get_min_word_dur,
                        get_prepend_punctuations)
from ..options import AllOptions
from ..result import WhisperResult, WordTiming
from ..stabilization import NonSpeechPredictor
from ..utils import format_timestamp, safe_print


@dataclass
class BasicWordTiming:
    word: str
    start: float
    end: float
    tokens: List[int]
    probability: float


@dataclass
class WordToken:
    word: str
    tokens: List[int]
    is_padding: bool = False

    def append(self, other: 'WordToken'):
        if self.is_padding or other.is_padding:
            raise TypeError('cannot append padding word tokens')
        self.word += other.word
        self.tokens += other.tokens

    def prepend(self, other: 'WordToken'):
        if self.is_padding or other.is_padding:
            raise TypeError('cannot prepend padding word tokens')
        self.word = other.word + self.word
        self.tokens = other.tokens + self.tokens


@dataclass
class _PendingWord:
    """State of the word held back for re-evaluation across passes."""
    word: Optional[BasicWordTiming] = None
    extra_words: Optional[List[BasicWordTiming]] = None
    mask: Optional[np.ndarray] = None
    offset: Optional[float] = None

    def clear(self):
        self.word = self.extra_words = self.mask = self.offset = None


def merge_punctuations(word_tokens: List[WordToken],
                       prepend_punctuations: Optional[str] = None,
                       append_punctuations: Optional[str] = None):
    """Fold punctuation-only word tokens into their neighbors in place."""
    if len(word_tokens) < 2:
        return
    prepend_punctuations = get_prepend_punctuations(prepend_punctuations)
    append_punctuations = get_append_punctuations(append_punctuations)
    for i in range(len(word_tokens) - 1, -1, -1):
        wt = word_tokens[i]
        if wt.is_padding:
            continue
        if (wt is not word_tokens[-1] and wt.word.startswith(' ')
                and wt.word.strip() in prepend_punctuations):
            word_tokens[i + 1].prepend(word_tokens.pop(i))
        wt = word_tokens[i]
        if (i != 0 and not wt.word.endswith(' ')
                and wt.word in append_punctuations):
            word_tokens[i - 1].append(word_tokens.pop(i))


def tokens_to_word_tokens(tokens: List[int], decode: Callable,
                          split_by_space: bool,
                          prepend_punctuations: Optional[str] = None,
                          append_punctuations: Optional[str] = None
                          ) -> List[WordToken]:
    """Group a token list into word-level WordTokens using ``decode``."""
    text: str = decode(tokens)
    out: List[WordToken] = []
    curr_tokens: List[int] = []
    for token in tokens:
        curr_tokens.append(token)
        curr_text = decode(curr_tokens)
        if text[:len(curr_text)] != curr_text:
            continue  # partial UTF-8 sequence; keep accumulating
        is_append = split_by_space and not curr_text.startswith(' ')
        if is_append and out:
            out[-1].word += curr_text
            out[-1].tokens += curr_tokens
        else:
            out.append(WordToken(curr_text, curr_tokens))
        text = text[len(curr_text):]
        curr_tokens = []
    if curr_tokens:
        out.append(WordToken(text, curr_tokens))
    elif len(text) != 0:
        out[-1].word += text
    merge_punctuations(out, prepend_punctuations, append_punctuations)
    return out


def pad_segment_word_tokens(segment_word_tokens: List[List[WordToken]],
                            padding: Optional[str], encode: Callable,
                            pad_first_seg: bool = True):
    """Insert gap-padding word tokens at segment starts (in place)."""
    if padding is None:
        return
    padding_tokens = encode(padding)
    pad_wt = WordToken(padding, padding_tokens, True)

    def starts_with_pad(tks: List[int]) -> bool:
        return len(tks) >= len(padding_tokens) and \
            tks[:len(padding_tokens)] == padding_tokens

    def ends_with_pad(tks: List[int]) -> bool:
        return len(tks) >= len(padding_tokens) and \
            tks[-len(padding_tokens):] == padding_tokens

    for i, word_tokens in enumerate(segment_word_tokens):
        if (starts_with_pad(word_tokens[0].tokens)
                or (i != 0 and ends_with_pad(segment_word_tokens[i - 1][-1].tokens))
                or (i == 0 and not pad_first_seg)):
            continue
        word_tokens.insert(0, pad_wt)


def flatten_segment_word_tokens(segment_word_tokens: List[List[WordToken]],
                                track_segment_index: bool = False
                                ) -> Tuple[List[WordToken], List[int]]:
    all_word_tokens: List[WordToken] = []
    segment_indices: List[int] = []
    for i, word_tokens in enumerate(segment_word_tokens):
        all_word_tokens.extend(word_tokens)
        if track_segment_index:
            segment_indices.extend(-1 if w.is_padding else i for w in word_tokens)
    return all_word_tokens, segment_indices


class Aligner:
    """See module docstring; constructor options mirror the reference."""

    def __init__(
            self,
            inference_func: Callable,
            decode: Callable,
            encode: Callable,
            split_words_by_space: bool = True,
            sample_rate: int = 16000,
            max_segment_length: Union[int, str] = '30s',
            time_precision: float = 0.02,
            *,
            remove_instant_words: bool = False,
            token_step: int = 100,
            original_split: bool = False,
            word_dur_factor: Optional[float] = 2.0,
            max_word_dur: Optional[float] = 3.0,
            nonspeech_skip: Optional[float] = 5.0,
            fast_mode: bool = False,
            failure_threshold: Optional[float] = None,
            batch_inference_func: Optional[Callable] = None,
            **options,
    ):
        if failure_threshold is not None and not 0 <= failure_threshold <= 1:
            raise ValueError(
                f'``failure_threshold`` ({failure_threshold}) must be between 0 and 1.')
        if isinstance(max_segment_length, str):
            if not max_segment_length.endswith('s'):
                raise ValueError('string ``max_segment_length`` must end with "s"')
            max_segment_length = int(float(max_segment_length[:-1]) * sample_rate)

        self.options = AllOptions(options)
        self.options.post.min_word_dur = get_min_word_dur(
            self.options.post.min_word_dur)
        self.prepend_punctuations = get_prepend_punctuations(
            self.options.post.prepend_punctuations)
        self.append_punctuations = get_append_punctuations(
            self.options.post.append_punctuations)

        self.sample_rate, self.n_samples = sample_rate, max_segment_length
        self.tokens_per_sec = round(1 / time_precision)
        self.inference_func = inference_func
        self.batch_inference_func = batch_inference_func
        self.decode, self.encode = decode, encode
        self.split_words_by_space = split_words_by_space
        self.remove_instant_words = remove_instant_words
        self.token_step, self.original_split = token_step, original_split
        self.word_dur_factor, self.max_word_dur = word_dur_factor, max_word_dur
        self.nonspeech_skip, self.fast_mode = nonspeech_skip, fast_mode
        self.failure_threshold = failure_threshold
        self.failure_count = self.max_fail = 0
        self.audio_loader: Optional[AudioLoader] = None
        self.nonspeech_predictor: Optional[NonSpeechPredictor] = None
        self._reset_queue_state()

    def _reset_queue_state(self):
        """Clear the per-align() word queue and seek bookkeeping."""
        self._pad_mask = None
        self._text = ''
        self._split_indices_by_char: List[int] = []
        self._all_word_tokens: List[WordToken] = []
        self._total_words = 0
        self._remaining_len = 0
        self._initial_duration = 0
        self._seek_sample = 0
        self._time_offset = 0.0
        self._pending = _PendingWord()
        self._curr_words: List[BasicWordTiming] = []
        self._nonspeech_preds = {}
        self._seg_word_tokens: List[WordToken] = []

    # -- properties ------------------------------------------------------------------
    # prepend/append punctuations are plain attributes; the combined set is
    # derived on read so the two can never drift out of sync.

    @property
    def all_punctuations(self):
        return (getattr(self, 'prepend_punctuations', '')
                + getattr(self, 'append_punctuations', ''))

    # -- entry points -----------------------------------------------------------------

    def align(self, audio, text: Union[str, List[int], WhisperResult],
              **options) -> Optional[WhisperResult]:
        """Align plain text / tokens / a prior result to ``audio``."""
        self._reset()
        self._load_text(text)
        self._load_audio(audio)
        self._load_nonspeech_detector()
        for k in list(options.keys()):
            if hasattr(self, k):
                setattr(self, k, options.pop(k))
        self.options.update(options)

        from ..utils import make_progress_bar
        self._pbar = make_progress_bar(self.audio_loader.get_duration(2),
                                       'Align', self.options.progress.verbose)
        result: List[BasicWordTiming] = []
        last_ts = 0.0
        while self._all_word_tokens:
            self._time_offset = self._seek_sample / self.sample_rate
            audio_segment = self.audio_loader.next_chunk(self._seek_sample,
                                                         self.n_samples)
            if audio_segment is None:
                break
            self._nonspeech_preds = self.nonspeech_predictor.predict(
                audio=audio_segment, offset=self._time_offset)

            audio_segment = self._skip_nonspeech(audio_segment)
            if audio_segment is None:
                continue

            self._curr_words = self._compute_timestamps(
                audio_segment, *self._get_curr_words())
            self._seg_word_tokens = [WordToken(w.word, w.tokens)
                                     for w in self._curr_words]

            last_ts = self._fallback(audio_segment.shape[-1])
            self._report_progress(last_ts)
            result.extend(self._curr_words)

            if self.options.progress.verbose:
                safe_print('\n'.join(
                    f'[{format_timestamp(w.start)}] -> '
                    f'[{format_timestamp(w.end)}] "{w.word}"'
                    for w in self._curr_words))

            if self.failure_threshold is not None:
                self.failure_count += sum(
                    1 for w in self._curr_words if w.end - w.start == 0)
                if self.failure_count > self.max_fail:
                    break

        if self._pending.word is not None:
            result.append(self._pending.word)
        if not result:
            warnings.warn('Failed to align text.', stacklevel=2)
        if self.failure_count > self.max_fail:
            warnings.warn(
                f'Alignment aborted. Failed word percentage exceeded '
                f'{self.failure_threshold * 100}% at '
                f'{format_timestamp(self._seek_sample / self.sample_rate)}.',
                stacklevel=2)
        elif self._all_word_tokens:
            last_ts_str = format_timestamp(result[-1].end if result else 0)
            warnings.warn(
                f'Failed to align the last {len(self._all_word_tokens)}/'
                f'{self._total_words} words after {last_ts_str}.', stacklevel=2)

        if self._all_word_tokens and not self.remove_instant_words:
            total_duration = self.audio_loader.get_duration(3)
            result.extend(BasicWordTiming(
                word=w.word, start=total_duration, end=total_duration,
                tokens=w.tokens, probability=0.0)
                for w in self._all_word_tokens)

        self._pbar.close()
        self._pbar = None
        self.audio_loader.terminate()
        self.nonspeech_predictor.finalize_timings()

        if not result:
            return None

        word_dicts = [dict(word=w.word, start=w.start, end=w.end,
                           tokens=w.tokens, probability=w.probability)
                      for w in result]
        if len(self._split_indices_by_char):
            word_lens = np.cumsum([len(w.word) for w in result])
            split_indices = [int(np.flatnonzero(word_lens >= i)[0]) + 1
                             for i in self._split_indices_by_char]
            final_result = WhisperResult([
                word_dicts[i:j]
                for i, j in zip([0] + split_indices[:-1], split_indices)
                if i != j
            ])
        else:
            final_result = WhisperResult([word_dicts])

        self._suppress_silence(final_result)
        if not self.original_split:
            final_result.regroup(self.options.post.regroup)

        fail_segs = sum(1 for s in final_result.segments if s.end - s.start <= 0)
        if fail_segs:
            warnings.warn(f'{fail_segs}/{len(final_result.segments)} segments '
                          f'failed to align.', stacklevel=2)
        return final_result

    def align_words(self, audio, result: Union[WhisperResult, List[dict]],
                    normalize_text: bool = True,
                    inplace: bool = True) -> WhisperResult:
        """Per-segment confined alignment (no fallback; drastically faster)."""
        self._reset()
        result, segment_tokens = self._load_result(result, normalize_text, inplace)
        self._load_audio(audio)
        self._load_nonspeech_detector()

        # Phase A (host, in order): audio spans + nonspeech prediction.
        pending = []  # (segment, audio_segment, word_tokens)
        end = 0.0
        for segment, curr_tokens in zip(result.segments, segment_tokens):
            self._time_offset = segment.start
            self._seek_sample = round(segment.start * self.sample_rate)
            end = segment.end
            if segment.duration == 0:
                continue
            segment_samples = round(segment.duration * self.sample_rate)
            audio_segment = self.audio_loader.next_chunk(self._seek_sample,
                                                         segment_samples)
            if audio_segment is None:
                break
            self.nonspeech_predictor.predict(audio=audio_segment,
                                             offset=self._time_offset)
            curr_word_tokens = tokens_to_word_tokens(
                curr_tokens, self.decode, self.split_words_by_space,
                self.options.post.prepend_punctuations,
                self.options.post.append_punctuations)
            pending.append((segment, audio_segment, curr_word_tokens))

        # Phase B: per-segment timing — segments are independent here
        # ("drastically faster", reference alignment.py:235-237), so the
        # batched backend computes every segment's forward in one pass.
        raw_outputs = [None] * len(pending)
        if self.batch_inference_func is not None and len(pending) > 1:
            raw_outputs = self.batch_inference_func(
                [(aud, wt) for _, aud, wt in pending])

        from ..utils import make_progress_bar
        self._pbar = make_progress_bar(self.audio_loader.get_duration(2),
                                       'Align', self.options.progress.verbose)
        for (segment, audio_segment, curr_word_tokens), raw in zip(
                pending, raw_outputs):
            word_timings = self._compute_timestamps(
                audio_segment, curr_word_tokens, raw_output=raw,
                time_offset=segment.start)
            segment.words = [WordTiming(**w.__dict__) for w in word_timings]
            self._report_progress(segment.end)
        self._pbar.close()
        self._pbar = None

        self.audio_loader.terminate()
        self.nonspeech_predictor.finalize_timings()
        result.reassign_ids()
        self._suppress_silence(result)
        result.regroup(self.options.post.regroup)
        return result

    # -- loading -----------------------------------------------------------------------

    def _reset(self):
        self._seek_sample = 0
        self._time_offset = 0.0
        self._pending.clear()
        self._curr_words = []
        self._nonspeech_preds = {}
        self._seg_word_tokens = []
        self._pbar = None

    @staticmethod
    def _standardize_text(text, original_split: bool = False):
        """Normalize whitespace; derive per-segment split points (by char)."""
        split_indices_by_char: List[int] = []
        if isinstance(text, WhisperResult):
            if original_split and len(text.segments) > 1 and text.has_words:
                split_indices_by_char = np.cumsum(
                    [sum(len(w.word) for w in seg.words)
                     for seg in text.segments]).tolist()
            text = text.text
        elif isinstance(text, str):
            if original_split and '\n' in text:
                lines = [' ' + norm for line in text.splitlines()
                         if (norm := re.sub(r'\s', ' ', line).strip())]
                split_indices_by_char = np.cumsum([len(s) for s in lines]).tolist()
                text = ''.join(lines)
            else:
                text = re.sub(r'\s', ' ', text)
                if not text.startswith(' '):
                    text = ' ' + text
        return text, split_indices_by_char

    def _load_text(self, text):
        self._text, self._split_indices_by_char = self._standardize_text(
            text, self.original_split)
        tokens = self.encode(self._text) if isinstance(self._text, str) else self._text
        self._all_word_tokens = tokens_to_word_tokens(
            tokens, self.decode, self.split_words_by_space)
        self._pad_mask = self._get_pad_mask(self.options.align.presplit)
        self._total_words = len(self._all_word_tokens)
        self._remaining_len = sum(len(w.word) for w in self._all_word_tokens)
        self.failure_count = 0
        self.max_fail = self._total_words * (self.failure_threshold or 1)

    def _load_result(self, result, normalize_text: bool = True,
                     inplace: bool = False):
        segment_tokens = None
        if isinstance(result, WhisperResult):
            if not inplace:
                result = copy.deepcopy(result)
        else:
            if result and not result[0]['text'] and result[0]['tokens']:
                segment_tokens = [seg['tokens'] for seg in result]
                for seg in result:
                    seg['text'] = self.decode(seg['tokens'])
            result = WhisperResult(result)

        if normalize_text:
            def norm_text(text: str) -> str:
                text = re.sub(r'\s', ' ', text)
                return text if text.startswith(' ') else ' ' + text
        else:
            def norm_text(text: str) -> str:
                return text

        if segment_tokens is None:
            segment_tokens = [self.encode(norm_text(seg.text))
                              for seg in result.segments]
        exceeding = [i for i, tokens in enumerate(segment_tokens)
                     if len(tokens) > self.token_step]
        if exceeding:
            raise RuntimeError('found segments at following indices exceeding '
                               f'max length for model: {exceeding}')
        return result, segment_tokens

    def _get_pad_mask(self, presplit) -> Optional[List[bool]]:
        """Per-character mask marking where gap padding may be inserted.

        With an original split (line breaks / prior segments), a word's
        characters are markable iff the word closes one of the recorded
        split points; otherwise any word ending in a presplit punctuation
        marks a boundary.
        """
        if not presplit:
            return None
        if isinstance(presplit, bool):
            presplit = get_append_punctuations(self.options.post.append_punctuations)

        def char_flags(flag_of_word):
            return [flag for wt in self._all_word_tokens
                    for flag in [flag_of_word(wt)] * len(wt.word)]

        if not self._split_indices_by_char:
            return char_flags(lambda wt: any(map(wt.word.endswith, presplit)))
        boundaries = list(self._split_indices_by_char)
        consumed = 0

        def closes_split(wt) -> bool:
            nonlocal consumed
            consumed += len(wt.word)
            if boundaries and consumed >= boundaries[0]:
                boundaries.pop(0)
                return True
            return False

        return char_flags(closes_split)

    def _load_audio(self, audio):
        if isinstance(audio, AudioLoader):
            self.audio_loader = audio
        else:
            self.audio_loader = AudioLoader(
                audio,
                sr=self.sample_rate,
                denoiser=self.options.pre.denoiser,
                denoiser_options=self.options.pre.denoiser_options,
                only_voice_freq=self.options.pre.only_voice_freq,
                verbose=self.options.progress.verbose,
                new_chunk_divisor=512,
                stream=self.options.pre.stream,
            )
        self._initial_duration = self.audio_loader.get_duration(2)

    def _load_nonspeech_detector(self):
        self.nonspeech_predictor = NonSpeechPredictor(
            vad=self.options.silence.vad if self.options.post.suppress_silence else None,
            get_mask=True,
            min_word_dur=self.options.post.min_word_dur,
            q_levels=self.options.silence.q_levels,
            k_size=self.options.silence.k_size,
            vad_threshold=self.options.silence.vad_threshold,
            vad_window=self.audio_loader.chunk_divisor or 512,
            sampling_rate=self.sample_rate,
            verbose=None if self.audio_loader.stream else self.options.progress.verbose,
            store_timings=True,
            ignore_is_silent=True,
            min_silence_dur=self.options.post.min_silence_dur,
        )
        self.audio_loader.update_post_prep_callback(
            self.nonspeech_predictor.get_on_prep_callback(self.audio_loader.stream))

    # -- per-pass machinery -----------------------------------------------------------------

    def _compute_timestamps(self, audio_segment: np.ndarray,
                            word_tokens: List[WordToken],
                            split_indices: Optional[List[int]] = None,
                            expect_gap: bool = False,
                            time_offset: Optional[float] = None,
                            raw_output=None,
                            ) -> List[BasicWordTiming]:
        """Run the backend on one segment and verify/assemble its output."""
        if split_indices:
            bounds = [0] + split_indices
            if bounds[-1] < len(word_tokens):
                bounds.append(len(word_tokens))
            grouped = [word_tokens[i:j] for i, j in zip(bounds[:-1], bounds[1:])]
            pad_segment_word_tokens(grouped, self.options.align.gap_padding,
                                    self.encode, expect_gap)
            input_word_tokens = flatten_segment_word_tokens(grouped)[0]
        else:
            input_word_tokens = word_tokens

        max_curr_ts = round(audio_segment.shape[-1] / self.sample_rate, 4)
        output = (raw_output if raw_output is not None
                  else self.inference_func(audio_segment, input_word_tokens))
        if len(output) < len(input_word_tokens):
            raise RuntimeError(
                f'expected output word count to be at least '
                f'{len(input_word_tokens)} but got {len(output)}')
        if output[-1]['start'] > max_curr_ts:
            warnings.warn(f'word "{output[-1]}" starts later than the max timestamp')
        if time_offset is None:
            time_offset = self._time_offset

        # Verify that backend words concatenate exactly to the input words.
        final_output: List[BasicWordTiming] = []
        i = 0
        curr_word = ''
        curr_start = -1.0
        probs: List[float] = []
        wti_max = len(output) - 1
        for wti, word_timing in enumerate(output):
            curr_word += word_timing['word']
            if curr_start == -1.0:
                curr_start = word_timing['start']
            if word_timing.get('probability'):
                probs.append(word_timing['probability'])
            input_word = input_word_tokens[i].word
            if curr_word == input_word:
                if not input_word_tokens[i].is_padding:
                    start = min(curr_start, max_curr_ts)
                    end = min(word_timing['end'], max_curr_ts)
                    final_output.append(BasicWordTiming(
                        input_word,
                        round(start + time_offset, 3),
                        round(end + time_offset, 3),
                        input_word_tokens[i].tokens,
                        float(np.mean(probs)) if probs else 0.0,
                    ))
                curr_word = ''
                curr_start = -1.0
                probs = []
                i += 1
            elif len(curr_word) > len(input_word) or wti == wti_max:
                raise RuntimeError(f'expect word "{input_word}" but got "{curr_word}"')
        return final_output

    def _get_curr_words(self):
        """Pop the next <= token_step tokens' worth of words off the queue."""
        all_word_tokens = self._all_word_tokens
        pad_mask = self._pad_mask
        curr_tk_count = 0
        word_tokens: List[WordToken] = []
        split_indices: List[int] = []
        is_start_gap = (
            True if self._remaining_len == len(pad_mask)
            else pad_mask[-(self._remaining_len + 1)]
        ) if pad_mask else True
        for i in range(len(all_word_tokens)):
            tk_count = len(all_word_tokens[0].tokens)
            head_len = len(all_word_tokens[0].word)
            has_split = bool(pad_mask and
                             pad_mask[-(self._remaining_len - head_len + 1)])
            m_count = 1 if has_split else 0
            if (curr_tk_count + len(split_indices) + tk_count + m_count
                    > self.token_step and word_tokens):
                break
            if has_split:
                split_indices.append(i + 1)
            self._remaining_len -= head_len
            word_tokens.append(all_word_tokens.pop(0))
            curr_tk_count += tk_count
        return word_tokens, split_indices, is_start_gap

    # -- fallback logic (the stabilizing trick) ---------------------------------------------

    def _speech_percentage(self, word: BasicWordTiming,
                           mask: Optional[np.ndarray], offset: float) -> float:
        """Fraction of the word's span predicted as speech (1 = all speech)."""
        if mask is None:
            return 1.0
        s = int((word.start - offset) * self.tokens_per_sec)
        e = int((word.end - offset) * self.tokens_per_sec)
        span = np.asarray(mask[s:e], dtype=np.float64)
        frac = span.mean() if span.size else np.nan
        return 1 - (0.0 if np.isnan(frac) else float(frac))

    def _is_new_better(self, word0, mask0, offset0, word1, mask1, offset1) -> bool:
        speech0 = round(self._speech_percentage(word0, mask0, offset0), 1)
        speech1 = round(self._speech_percentage(word1, mask1, offset1), 1)
        w0p, w1p = word0.probability, word1.probability
        return ((w1p ** 0.75 - w0p ** 0.75) < 0.35 and speech0 >= speech1) \
            or w0p >= w1p

    def _fix_temp_words(self, target_word: BasicWordTiming,
                        word_sources: List[BasicWordTiming],
                        second_target: Optional[BasicWordTiming] = None):
        """Merge held-back words so they line up with the new pass's words."""
        head = word_sources[0]
        assert target_word.word.startswith(head.word)
        if target_word.word == head.word:
            if second_target and len(word_sources) > 1:
                # align the remainder against the following target word too
                tail_head, tail = self._fix_temp_words(second_target,
                                                       word_sources[1:])
                return head, ([tail_head] + tail if tail_head is not None
                              else tail)
            return head, [] if second_target else word_sources[1:]
        # head is a fragment of the target: absorb followers until the texts
        # match (punctuation-only fragments don't advance the time span)
        if len(word_sources) < 2:
            return None, []
        probs = [head.probability]
        if head.word.strip() in self.all_punctuations:
            head.start = word_sources[1].start
            head.end = word_sources[1].end
        while len(word_sources) > 1:
            follower = word_sources.pop(1)
            grown = head.word + follower.word
            assert target_word.word.startswith(grown)
            head.word = grown
            head.tokens += follower.tokens
            probs.append(follower.probability)
            if follower.word.strip() not in self.all_punctuations:
                head.end = follower.end
            if target_word.word == head.word:
                break
        if target_word.word != head.word:
            return None, []
        head.probability = float(np.mean(probs))
        return head, word_sources[1:]

    def _update_curr_words(self):
        if self._pending.word is None:
            return
        temp_words = [self._pending.word] + \
            self._pending.extra_words[:len(self._curr_words) - 1]
        self._curr_words[:len(temp_words)] = temp_words
        self._pending.word = None

    def _redo_words(self, index: Optional[int] = None):
        """Requeue words from ``index`` onward; reconcile the pending word."""
        if index is not None and self._curr_words and self._pending.word is not None:
            self._pending.word, self._pending.extra_words = self._fix_temp_words(
                self._curr_words[0],
                [self._pending.word] + self._pending.extra_words,
                self._curr_words[1] if len(self._curr_words) > 1 else None)
            if self._pending.word:
                use_new = self._is_new_better(
                    self._curr_words[0], self._nonspeech_preds['mask'],
                    self._time_offset,
                    self._pending.word, self._pending.mask, self._pending.offset)
                new_extra_words = []
                if use_new:
                    self._pending.word = self._curr_words[0]
                else:
                    for cw, tw in zip(self._curr_words[1:],
                                      self._pending.extra_words):
                        assert cw.word.startswith(tw.word)
                        use_new = self._is_new_better(
                            cw, self._nonspeech_preds['mask'], self._time_offset,
                            tw, self._pending.mask, self._pending.offset)
                        if use_new or cw.word != tw.word or cw.end < tw.end:
                            break
                        new_extra_words.append(tw)
                self._pending.extra_words = new_extra_words

        if index is None:  # redo all
            self._remaining_len += sum(len(w.word) for w in self._seg_word_tokens)
            self._all_word_tokens = self._seg_word_tokens + self._all_word_tokens
            self._curr_words = []
            self._pending.word = None
        elif index != len(self._seg_word_tokens):  # redo from index
            self._remaining_len += sum(len(w.word)
                                       for w in self._seg_word_tokens[index:])
            self._all_word_tokens = (self._seg_word_tokens[index:]
                                     + self._all_word_tokens)
            self._curr_words, new_extra = (self._curr_words[:index],
                                           self._curr_words[index:])
            if self._curr_words:
                self._update_curr_words()
                self._remaining_len += sum(
                    len(w.word) for w in self._seg_word_tokens[index - 1:index])
                self._all_word_tokens = (self._seg_word_tokens[index - 1:index]
                                         + self._all_word_tokens)
                self._pending.word = self._curr_words.pop(-1)
                self._pending.extra_words = new_extra
                self._pending.mask = self._nonspeech_preds['mask']
                self._pending.offset = self._time_offset
        else:
            self._update_curr_words()

    def _skip_nonspeech(self, audio_segment: np.ndarray) -> Optional[np.ndarray]:
        """Jump over nonspeech sections >= ``nonspeech_skip`` seconds."""
        if self.nonspeech_skip is None:
            return audio_segment
        timings = self._nonspeech_preds['timings']
        if timings is None or len(timings[0]) == 0:
            return audio_segment

        segment_samples = audio_segment.shape[-1]
        segment_duration = segment_samples / self.sample_rate
        max_time_offset = self._time_offset + self.options.post.min_word_dur
        min_time_offset = self._time_offset - self.options.post.min_word_dur

        if (timings[0][0] < max_time_offset
                and timings[1][0] > min_time_offset + segment_duration):
            # whole segment inside the first nonspeech section
            self._seek_sample += segment_samples
            return None

        valid = (timings[1] - timings[0]) >= self.nonspeech_skip
        if not valid.any():
            return audio_segment
        nonspeech_starts = timings[0][valid]
        if max_time_offset < nonspeech_starts[0]:
            return audio_segment
        nonspeech_ends = timings[1][valid]
        total_samples = round(self.audio_loader.get_duration() * self.sample_rate)

        self._seek_sample = round(nonspeech_ends[0] * self.sample_rate)
        if (self._seek_sample + self.options.post.min_word_dur * self.sample_rate
                > total_samples):
            self._seek_sample = total_samples
            return None
        self._time_offset = self._seek_sample / self.sample_rate

        audio_segment = self.audio_loader.next_chunk(self._seek_sample,
                                                     self.n_samples)
        if audio_segment is None:
            return None
        self._nonspeech_preds = self.nonspeech_predictor.predict(
            audio=audio_segment, offset=self._time_offset)
        if len(nonspeech_starts) > 1:
            new_count = round((nonspeech_starts[1] - nonspeech_ends[0])
                              * self.sample_rate)
            audio_segment = audio_segment[:new_count]
        return audio_segment

    def _duration_caps(self, med_dur: float):
        """(local cap, global cap, capped median) for this pass.

        The local cap is ``word_dur_factor`` x the pass median, tightened by
        the absolute ``max_word_dur``; the global cap is the absolute limit
        (falling back to the local one when no absolute limit is set).
        """
        if self.fast_mode:
            return None, None, med_dur
        local_cap = (round(med_dur * self.word_dur_factor, 3)
                     if self.word_dur_factor else None)
        if self.max_word_dur:
            global_cap = self.max_word_dur
            local_cap = min(local_cap, global_cap) if local_cap else global_cap
        else:
            global_cap = local_cap or None
        if global_cap and med_dur > global_cap:
            med_dur = global_cap
        return local_cap, global_cap, med_dur

    def _fallback(self, segment_samples: int) -> float:
        """Keep words up to the last trustworthy timestamp; requeue the rest."""
        durations = np.array([w.end - w.start for w in self._curr_words]).round(3)
        timed = np.flatnonzero(durations > 0)
        if not len(timed):
            # no word got a usable span: skip the window, redo everything
            self._seek_sample += segment_samples
            self._redo_words()
            return round(self._seek_sample / self.sample_rate, 2)

        # a final word running into the window edge is not trustworthy
        window_end = np.floor(self._time_offset
                              + segment_samples / self.sample_rate)
        if (self._all_word_tokens and len(timed) > 1
                and self._curr_words[timed[-1]].end >= window_end):
            timed = timed[:-1]
        keep_until = timed[-1] + 1
        local_cap, global_cap, med_dur = self._duration_caps(
            np.median(durations[:keep_until]))

        # an over-long FIRST timed word means the whole window started too
        # late — rewind the seek instead of keeping any of this pass
        # (note: gated on the local cap, compared against the global one,
        # mirroring reference alignment.py:975)
        rewind_to = None
        if local_cap and durations[timed[0]] > global_cap:
            first = self._curr_words[timed[0]]
            rewind_to = round(max(first.end - (med_dur * timed[0] + local_cap),
                                  first.start), 3)
            if rewind_to <= self._time_offset:
                rewind_to = None

        if rewind_to is not None:
            last_ts = rewind_to
            self._redo_words()
        else:
            if global_cap:
                scan_from = timed[0] + 1
                too_long = np.flatnonzero(
                    durations[scan_from:keep_until] > global_cap)
                if len(too_long):
                    keep_until = too_long[0] + scan_from
            last_ts = self._curr_words[keep_until - 1].end
            self._redo_words(keep_until)
        self._seek_sample = round(last_ts * self.sample_rate)
        return last_ts

    # -- post ------------------------------------------------------------------------------

    def _suppress_silence(self, result: WhisperResult):
        if not self.options.post.suppress_silence:
            return
        nonspeech_timings = self.nonspeech_predictor.nonspeech_timings
        if nonspeech_timings is None:
            return
        result.suppress_silence(
            *nonspeech_timings,
            min_word_dur=self.options.post.min_word_dur,
            word_level=self.options.post.suppress_word_ts,
            nonspeech_error=self.options.post.nonspeech_error,
            use_word_position=self.options.post.use_word_position,
            verbose=self.options.progress.verbose is not None,
        )
        result.update_nonspeech_sections(*nonspeech_timings)
        result.set_current_as_orig()

    def _report_progress(self, last_ts: float):
        from ..utils import progress_update
        progress_update(getattr(self, '_pbar', None), last_ts)
        if self.options.progress.progress_callback is not None:
            total = self.audio_loader.get_duration(2)
            self.options.progress.progress_callback(
                min(round(last_ts, 2), total), total)
