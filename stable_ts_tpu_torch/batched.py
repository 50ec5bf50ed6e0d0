"""Batched (window-data-parallel) transcription, the throughput path (port
of stable_ts_tpu/batched.py).

Fixed-stride 30-s windows are read in ``batch_size`` groups from the
streaming :class:`~.audio.loader.AudioLoader`; each group is encoded ONCE,
and its features feed every temperature-fallback rung and the word-timing
pass. The word-timing pass runs batched over right-padded token rows
(exact under the causal mask): one teacher-forced capture pass a group,
the head weights scored on the device (all windows at once with known
heads, ``models/whisper/timing.py:known_heads_pass``; one window at a
time with dynamic heads or the 'new' aligner), and one DTW-cost launch
for the group. ``condition_on_previous_text=True``
chains GROUPS: every window of group g is prompted with the decoded tail
of group g-1, with the reference's T > 0.5 prompt reset.

The groups move through JAX's three-stage pipeline in its order: the
decode of group g, then the collection (fallback, segments) and the
word-timing launch of group g-1, then the word assembly of group g-2. JAX
gets its overlap from asynchronous dispatch. The port's decode loops wait
on the device to stop: the greedy loop reads its stop flag one step late
(the card runs step i while the host queues step i + 1), the sampling and
beam loops every step. So the decode of a group has ended when
:meth:`decode_launch` returns, but for the one step a greedy loop queues
past its stop. The port's overlap comes from a second CUDA
stream instead: a group's word-timing pass is queued there, ordered after
the group's features by an event, and its kernels fill the gaps of the
next group's decode on the main stream; its results (each window's token
probabilities and the group's DTW costs) come back through pinned host
buffers with an event that the word assembly waits on. The host walks the
traceback over the downloaded costs (``ops/dtw.py:dtw_jumps_batched``;
JAX walks it on the device). On the CPU the same code runs with no
streams and no pinned memory: it branches on the model's device.

On a (dp, tp) mesh (``model.shard``) every rank runs this driver on the
same audio. The group's encode and decode split the windows over dp inside
``model.embed_audio`` and ``model.decode_launch`` (JAX calls
``shard_batch`` before them, batched.py:589, :680) and hand back the
group's global features and results, so this driver never sees a
dp-padded batch and JAX's repairs for one (batched.py:617-623, :684-688)
have no counterpart. The word-timing pass calls ``model.shard_batch`` on
its rows as JAX does (batched.py:972-973), scores this rank's windows, and
gathers the token probabilities and the DTW costs over dp before they go
to the host. Every rank issues these collectives in the same host order,
on either stream. An out-of-memory error in a decode on any rank raises
on every rank (``model.decode_launch`` agrees on it), so all of them halve
the batch together.
"""
import contextlib
import gc
import time
import traceback
import warnings
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from .audio.loader import AudioLoader
from .constants import (N_FRAMES, N_SAMPLES, N_SAMPLES_PER_TOKEN, SAMPLE_RATE,
                        TOKENS_PER_SECOND)
from .defaults import (get_append_punctuations, get_min_word_dur,
                       get_prepend_punctuations)
from .models.whisper.decoding import DecodingOptions
from .models.whisper.model import decoder_apply
from .models.whisper.timing import (_next_token_probs, attach_words,
                                    build_head_capture_table,
                                    dynamic_weights_device, known_heads_pass,
                                    new_aligner_matrix_device,
                                    parse_dynamic_heads, split_word_tokens,
                                    words_from_jumps)
from .ops.dtw import dtw_cost, dtw_jumps_batched
from .ops.mel import log_mel_spectrogram
from .parallel.mesh import batch_rows
from . import profiling
from .profiling import traced
from .result import Segment, WhisperResult
from .stabilization import NonSpeechPredictor
from .utils import (decode_acceptable, format_timestamp,
                    keep_segment_instant_rule, make_progress_bar,
                    progress_update, safe_print, timestamp_spans)


def _bucket(n: int, step: int = 64) -> int:
    return max(step, ((n + step - 1) // step) * step)


# Host-phase accounting (seconds, cumulative since the last clear): the
# host's share of a request, split by stage. With the recorder on, each
# phase is also a span (profiling.py).
HOST_PHASES = {}


def _phase(name: str) -> int:
    """The start of host phase ``name`` on the clock; :func:`_hp` ends it."""
    t0 = time.perf_counter_ns()
    profiling.open_at(name, t0)
    return t0


def _hp(name: str, t0: int):
    t1 = time.perf_counter_ns()
    HOST_PHASES[name] = HOST_PHASES.get(name, 0.0) + (t1 - t0) / 1e9
    profiling.close_at(name, t1)


class _Group:
    """One batch of non-silent 30-s windows moving through the pipeline."""
    __slots__ = ('metas', 'windows', 'features', 'pending', 'results',
                 'segments', 'timing', 'prompt', 'end_sample')

    def __init__(self, metas, windows):
        self.metas = metas          # [{seek, samples, silence_timings}]
        self.windows = windows      # (batch_size, row) float32 view of a
                                    # persistent buffer; rows past
                                    # len(metas) repeat the last real window
        self.features = None        # (batch_size, 1500, d) on the device
        self.pending = None         # PendingDecode
        self.results = None         # [DecodingResult] per window
        self.segments = None        # [[segment dict]] per window
        self.timing = None          # the launched word-timing work
        self.prompt = None          # prompt tokens used for this group
        self.end_sample = metas[-1]['seek'] + metas[-1]['samples']


# device memory kept out of the cap's budget: the decode's and the timing
# pass's workspace (the fused self-attention weights, the f32 embedding
# copy, the median filter's sort) and the allocator's fragmentation
_CAP_MARGIN_BYTES = 2 << 30


def _hbm_batch_cap(model, beam: int = 1) -> Optional[int]:
    """Window-batch capacity of the model's card (batched.py:164-192).

    Per window: JAX's terms, the cross K/V (L x 1500 x d, int8 from d >=
    1024, else 2 bytes, K and V), the self cache (L x 256 x (d + 4) x 2)
    per beam, the features of two pipelined groups and the timing pass's
    selective capture. Not counted: the full capture of the dynamic-heads
    and 'new' modes (L x H x 256 x 1500 bf16, 0.49 GB a window at
    large-v3), as in JAX. The budget is the card's free memory plus what
    the caching allocator holds unused, less ``_CAP_MARGIN_BYTES``; the
    resident weights (parameters and buffers: a ``dq`` model's int8
    weights and scales are buffers) are allocated already and so lie
    outside it. A model on the CPU, or no model, is uncapped (None); the
    out-of-memory halving in :func:`transcribe_batched` is the backstop."""
    dims = getattr(model, 'dims', None)
    device = getattr(model, 'device', None)
    if dims is None or device is None or torch.device(device).type != 'cuda':
        return None
    L, d = dims.n_text_layer, dims.n_text_state
    kv_item = 1 if dims.n_audio_state >= 1024 else 2  # kv_quant auto
    cache_len = min(dims.n_text_ctx, 256)
    per_window = (L * 1500 * d * kv_item * 2
                  + L * cache_len * (d + 4) * 2 * max(beam, 1)
                  + 1500 * d * 2 * 2
                  + 8 * 448 * 1500 * 2)
    free, _ = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    budget = free + cached - _CAP_MARGIN_BYTES
    if budget <= per_window:
        return 1
    return int(budget // per_window)


def transcribe_batched(model, audio, *, batch_size: int = 8, **kwargs
                       ) -> WhisperResult:
    """Capacity-guarded entry (batched.py:195-221): caps ``batch_size`` by
    :func:`_hbm_batch_cap`, and when the card runs out of memory
    (``torch.OutOfMemoryError``, nothing else) halves the window batch and
    retries with a warning. Before the retry every reference to the failed
    attempt (its groups, its pending decode, the frames of the exception's
    traceback) is dropped and the allocator's cache is emptied. Semantics
    and options: see :func:`_transcribe_batched_impl`."""
    cap = _hbm_batch_cap(model, beam=int(kwargs.get('beam_size') or 1))
    if cap is not None and batch_size > cap:
        warnings.warn(
            f'batch_size={batch_size} exceeds the estimated device memory '
            f'capacity of {cap} windows for this model; using {cap}. Pass a '
            f'smaller batch_size to silence this.')
        batch_size = cap
    with profiling.span('batched.request', request=True):
        while True:
            try:
                return _transcribe_batched_impl(model, audio,
                                                batch_size=batch_size, **kwargs)
            except torch.OutOfMemoryError as exc:
                if batch_size <= 1:
                    raise
                # the frames hold the failed attempt's groups and tensors
                traceback.clear_frames(exc.__traceback__)
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
            batch_size = max(1, batch_size // 2)
            warnings.warn(
                f'device out of memory; retrying transcription with '
                f'batch_size={batch_size} (pass a smaller batch_size to '
                f'avoid the restart)')


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A CPU copy of ``t``: queued into pinned memory without waiting when
    ``t`` is on the card (read it after the stream's event), ``t`` itself
    on the CPU."""
    if t.device.type == 'cpu':
        return t
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    return buf


@traced('transcribe_batched')
def _transcribe_batched_impl(
        model,
        audio,
        *,
        batch_size: int = 8,
        language: Optional[str] = None,
        task: str = 'transcribe',
        temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
        compression_ratio_threshold: Optional[float] = 2.4,
        logprob_threshold: Optional[float] = -1.0,
        no_speech_threshold: Optional[float] = 0.6,
        condition_on_previous_text: bool = False,
        initial_prompt: Optional[str] = None,
        word_timestamps: bool = True,
        regroup: Union[bool, str] = True,
        suppress_silence: bool = True,
        suppress_word_ts: bool = True,
        use_word_position: bool = True,
        vad: Union[bool, dict, str] = False,
        vad_threshold: float = 0.35,
        q_levels: int = 20,
        k_size: int = 5,
        denoiser: Optional[str] = None,
        denoiser_options: Optional[dict] = None,
        only_voice_freq: bool = False,
        min_word_dur: Optional[float] = None,
        min_silence_dur: Optional[float] = None,
        nonspeech_error: float = 0.1,
        nonspeech_skip: Optional[float] = None,
        suppress_ts_tokens: bool = False,
        gap_padding: Optional[str] = ' ...',
        max_instant_words: float = 0.5,
        avg_prob_threshold: Optional[float] = None,
        prepend_punctuations: Optional[str] = None,
        append_punctuations: Optional[str] = None,
        verbose: Optional[bool] = False,
        progress_callback: Optional[Callable] = None,
        dynamic_heads: Optional[Union[bool, int, str]] = None,
        aligner: Union[str, dict] = 'legacy',
        clip_timestamps: Optional[Union[str, List[float]]] = None,
        stream: Optional[bool] = None,
        only_ffmpeg: bool = False,
        split_callback: Optional[Callable] = None,
        resume=None,
        vad_onnx: bool = False,
        demucs=None,
        demucs_options: Optional[dict] = None,
        extra_models: Optional[list] = None,
        ignore_compatibility: bool = False,
        mel_first: Optional[bool] = None,
        suppress_attention: bool = False,
        time_scale: Optional[float] = None,
        ts_num: int = 0,
        ts_noise: Optional[float] = None,
        **decode_options,
) -> WhisperResult:
    """Transcribe with all 30-s windows batched (throughput-optimized); the
    parameters and behavior of stable_ts_tpu's ``transcribe_batched``.

    Semantics match :func:`~.transcribe.transcribe_stable` with
    fixed-stride windows. ``condition_on_previous_text`` defaults to False
    (independent windows); True chains prompts at GROUP granularity (see
    the module docstring). ``nonspeech_skip`` follows the sequential
    driver's re-seek rule: a long silence starting a window is jumped
    over, and one in the middle trims the window to the pre-silence span,
    the next window starting after it. ``avg_prob_threshold`` discards a
    failing window's segments but does not rewind the seek. Unknown
    keyword arguments raise here."""
    valid_extra = {'sample_len', 'best_of', 'beam_size', 'patience',
                   'length_penalty', 'prefix', 'suppress_tokens',
                   'suppress_blank', 'without_timestamps',
                   'max_initial_timestamp', 'kv_quant', 'prompt'}
    unknown = set(decode_options) - valid_extra
    if unknown:
        raise TypeError(
            f'transcribe_batched got unsupported keyword argument(s): '
            f'{", ".join(sorted(unknown))}. Supported decode options: '
            f'{", ".join(sorted(valid_extra - {"prompt"}))}.')
    if decode_options.get('prompt') is not None:
        if initial_prompt is not None:
            raise TypeError('pass either prompt= or initial_prompt=, not both')
        initial_prompt = decode_options.pop('prompt')
    else:
        decode_options.pop('prompt', None)
    if decode_options.get('beam_size') is None:
        decode_options.pop('beam_size', None)
    elif decode_options['beam_size'] > 1 and batch_size > 1:
        # the cross K/V is kept once per window (the beams share it), so the
        # window group only shrinks to keep windows x beams within 128 rows
        # of self cache; the vocab projection takes at most 256 rows
        max_rows = 128
        scaled = max(1, min(batch_size,
                            max_rows // int(decode_options['beam_size'])))
        if scaled != batch_size:
            warnings.warn(
                f'beam_size={decode_options["beam_size"]}: window batch '
                f'scaled {batch_size} -> {scaled} to keep windows x beams '
                f'within the device budget (pass a smaller batch_size '
                f'explicitly to silence this).')
            batch_size = scaled

    if extra_models:
        raise NotImplementedError(
            'extra_models is not supported by the batched driver; use '
            'model.transcribe() (the sequential driver) for multi-model '
            'alignment')
    # deprecated no-op knobs, accepted with the reference's warnings
    if mel_first is not None:
        warnings.warn('``mel_first`` is deprecated and will be removed in '
                      'future versions. Use ``stream`` (e.g. replace '
                      '``mel_first=True`` with ``stream=False``).',
                      stacklevel=2)
        stream = not mel_first
    if suppress_attention:
        warnings.warn('``suppress_attention`` is deprecated and will be '
                      'removed in future versions', stacklevel=2)
    if time_scale:
        warnings.warn('``time_scale`` is deprecated and will be removed in '
                      'future versions. It currently does not affect '
                      'results.', stacklevel=2)
    if ts_num:
        warnings.warn('``ts_num`` is deprecated and will be removed in '
                      'future versions.', stacklevel=2)
    if ts_noise:
        warnings.warn('``ts_noise`` is deprecated and will be removed in '
                      'future versions.', stacklevel=2)
    del ignore_compatibility  # no torch-whisper version surface to check

    min_word_dur = get_min_word_dur(min_word_dur)
    prepend_punctuations = get_prepend_punctuations(prepend_punctuations)
    append_punctuations = get_append_punctuations(append_punctuations)
    punctuations = prepend_punctuations + append_punctuations
    temperatures = ([temperature] if isinstance(temperature, (int, float))
                    else list(temperature))
    time_precision = 1.0 / TOKENS_PER_SECOND
    device = model.device
    on_card = device.type == 'cuda'
    # the stream the word-timing passes run on, beside the decode's
    timing_stream = torch.cuda.Stream(device=device) if on_card else None

    if isinstance(clip_timestamps, str):
        clip_timestamps = [float(t) for t in clip_timestamps.split(',') if t]
    load_sections = None
    if clip_timestamps:
        pairs = list(clip_timestamps) + ([None] if len(clip_timestamps) % 2
                                         else [])
        load_sections = [(pairs[i], pairs[i + 1])
                         for i in range(0, len(pairs), 2)]

    from .audio.denoiser import convert_demucs_kwargs
    denoiser, denoiser_options = convert_demucs_kwargs(
        denoiser, denoiser_options, demucs=demucs,
        demucs_options=demucs_options)
    denoiser_options = dict(denoiser_options or {})
    denoised_save_path = denoiser_options.pop('save_path', None)
    # int16 PCM passed directly rides int16 to the device: the loader's
    # /32768 is reversed exactly at the upload (every sample is k/32768,
    # exact in f32) and the mel scales it back (ops/mel.py), halving the
    # upload's bytes with results bit-identical to the f32 path. Mono only:
    # a stereo downmix has half-integer samples.
    pcm_exact = (isinstance(audio, np.ndarray)
                 and audio.dtype == np.int16 and audio.ndim == 1
                 and denoiser is None and not only_voice_freq)
    loader = audio if isinstance(audio, AudioLoader) else AudioLoader(
        audio,
        stream=stream,
        denoiser=denoiser,
        denoiser_options=denoiser_options,
        only_voice_freq=only_voice_freq,
        only_ffmpeg=only_ffmpeg,
        verbose=verbose,
        new_chunk_divisor=512 if vad else None,
        load_sections=load_sections,
        save_path=denoised_save_path,
    )

    def _pad_or_trim_mask(mask, length):
        if mask.shape[-1] >= length:
            return mask[..., :length]
        return np.pad(mask, (0, length - mask.shape[-1]))

    predictor = NonSpeechPredictor(
        vad=vad if suppress_silence else None,
        mask_pad_func=_pad_or_trim_mask,
        get_mask=suppress_ts_tokens,
        min_word_dur=min_word_dur,
        q_levels=q_levels, k_size=k_size,
        vad_threshold=vad_threshold,
        vad_onnx=vad_onnx,
        sampling_rate=SAMPLE_RATE,
        verbose=None,
        store_timings=True,
        min_silence_dur=min_silence_dur,
    )
    loader.update_post_prep_callback(
        predictor.get_on_prep_callback(loader.stream))

    total_duration = loader.get_duration(2)
    pbar = make_progress_bar(total_duration, task.title(), verbose)
    seek_sample = 0

    # -- resume (the sequential driver's semantics: pick up from a saved
    # partial result) ----------------------------------------------------------
    if resume is not None:
        remove_last_seg = False
        if not isinstance(resume, WhisperResult):
            if isinstance(resume, str) and resume.endswith('+'):
                resume = resume[:-1]
                remove_last_seg = True
            resume = WhisperResult(resume)
        if len(resume.segments) and remove_last_seg:
            del resume[-1]
            resume.unfinished_start = -1.0
        if resume.unfinished_start == -1.0:
            resume_start = resume[-1].end if len(resume.segments) else 0.0
        else:
            resume_start = resume.unfinished_start
        seek_sample = round(resume_start * SAMPLE_RATE)
        if verbose is not None:
            print(f'Resuming from {format_timestamp(resume_start)}')
        language = resume.language

    tokenizer = None
    initial_prompt_tokens: List[int] = []
    all_tokens: List[int] = []          # conditioning context
    prompt_reset_since = 0
    all_segments: List[dict] = []
    first_group = True

    # -- pipeline stages -----------------------------------------------------------

    # Persistent window buffers (pinned on the card's host, so the upload
    # copies without staging): rows are written straight into one of two
    # alternating full-capacity buffers. Two, because a group's buffer may
    # still be uploading while the next group is read.
    win_bufs = {}
    # the loader rounds chunk requests UP to its divisor (VAD window
    # alignment), so a full window row can exceed N_SAMPLES
    _div = getattr(loader, 'chunk_divisor', None) or 1
    win_row_len = int(-(-N_SAMPLES // _div) * _div)

    def host_buffer(shape, dtype):
        return torch.empty(shape, dtype=dtype, pin_memory=on_card)

    def read_group(flip=[0]) -> Optional[_Group]:
        """Host: next ``batch_size`` non-silent windows from the loader."""
        nonlocal seek_sample
        flip[0] ^= 1
        buf_t = win_bufs.get(flip[0])
        if buf_t is None or buf_t.shape[0] != batch_size:
            buf_t = win_bufs[flip[0]] = host_buffer((batch_size, win_row_len),
                                                    torch.float32)
        buf = buf_t.numpy()
        metas, wins = [], []
        while len(wins) < batch_size:
            _t0 = _phase('host_load')
            chunk, new_seek = loader.next_valid_chunk(seek_sample, N_SAMPLES)
            _hp('host_load', _t0)
            if chunk is None:
                break
            seek_sample = new_seek
            offset = seek_sample / SAMPLE_RATE
            _t0 = _phase('host_silence_predict')
            preds = predictor.predict(chunk, offset=offset)
            _hp('host_silence_predict', _t0)
            samples = int(chunk.shape[-1])
            if preds['is_silent']:
                seek_sample += samples
                continue
            next_seek = seek_sample + samples
            if nonspeech_skip and preds['timings'] is not None:
                # the reference's re-seek rule (original_whisper.py:513-527):
                # a long silence STARTING the window is jumped over; a long
                # silence mid-window trims the window to the pre-silence
                # span and the next window starts after the silence
                sil_starts = preds['timings'][0] - offset
                sil_ends = preds['timings'][1] - offset
                long_idx = np.flatnonzero(
                    (sil_ends - sil_starts) >= nonspeech_skip)
                if len(long_idx):
                    i = long_idx[0]
                    if (sil_starts[i] < min_word_dur
                            or int(sil_starts[i] * SAMPLE_RATE) == 0):
                        seek_sample += min(
                            samples, round(sil_ends[i] * SAMPLE_RATE))
                        continue
                    trim = int(sil_starts[i] * SAMPLE_RATE)
                    if trim < samples:
                        chunk = chunk[..., :trim]
                        samples = trim
                        next_seek = seek_sample + min(
                            round(sil_ends[i] * SAMPLE_RATE),
                            N_SAMPLES)
            metas.append(dict(
                seek=seek_sample, samples=samples,
                silence_timings=(preds['timings'] if suppress_silence
                                 else None),
                ts_mask=(preds['mask'] if suppress_ts_tokens else None)))
            _t0 = _phase('host_window_stack')
            row = buf[len(wins)]
            row[:samples] = chunk[..., :samples]
            if samples < win_row_len:
                row[samples:] = 0.0
            wins.append(None)
            _hp('host_window_stack', _t0)
            seek_sample = next_seek
        if not wins:
            return None
        n = len(wins)
        profiling.count('batched.windows_real', n)
        profiling.count('batched.windows_padded', batch_size - n)
        if n < batch_size:
            # pad the tail group in place (repeat the last real row)
            _t0 = _phase('host_window_stack')
            buf[n:] = buf[n - 1]
            _hp('host_window_stack', _t0)
        return _Group(metas, buf_t)

    pcm_bufs, pcm_flip = {}, [0]   # persistent int16 upload staging

    def launch_decode(grp: _Group):
        """Encode the group ONCE and decode it at the first temperature."""
        nonlocal tokenizer, language, initial_prompt_tokens, first_group
        wins = grp.windows     # full-capacity persistent buffer, pre-padded
        grp.windows = None
        _t0 = _phase('host_window_prep')
        if pcm_exact:
            # reverse the loader's /32768 (exact, see pcm_exact above) so
            # the upload moves int16; `wins` is consumed right here, so it
            # is scaled in place
            np.multiply(wins.numpy(), 32768.0, out=wins.numpy())
            pcm_flip[0] ^= 1
            key = (tuple(wins.shape), pcm_flip[0])
            buf = pcm_bufs.get(key)
            if buf is None:
                buf = pcm_bufs[key] = host_buffer(tuple(wins.shape), torch.int16)
            np.copyto(buf.numpy(), wins.numpy(), casting='unsafe')
            wins = buf
        _hp('host_window_prep', _t0)
        _t0 = _phase('host_upload_dispatch')
        wins = wins.to(device, non_blocking=True)
        mels = log_mel_spectrogram(wins, model.dims.n_mels)[..., :N_FRAMES]
        # on a mesh: each rank encodes its rows; the features come back
        # whole (JAX: shard_batch(mels), batched.py:589)
        grp.features = model.embed_audio(mels)
        profiling.count('encoder.windows', len(grp.metas))
        _hp('host_upload_dispatch', _t0)
        if tokenizer is None:
            if language is None:
                if model.is_multilingual:
                    langs, _ = model.detect_language(grp.features[:1])
                    language = langs[0]
                    if verbose is not None:
                        print(f'Detected language: {language}')
                else:
                    language = 'en'
            tokenizer = model.get_tokenizer(language=language, task=task)
            if initial_prompt is not None:
                initial_prompt_tokens = (
                    tokenizer.encode(' ' + str(initial_prompt).strip())
                    if isinstance(initial_prompt, str)
                    else list(initial_prompt))
                all_tokens.extend(initial_prompt_tokens)
        if condition_on_previous_text:
            prompt = all_tokens[prompt_reset_since:]
        else:
            prompt = initial_prompt_tokens if first_group else []
        first_group = False
        grp.prompt = prompt or None
        mask = _group_ts_mask(grp, range(len(grp.metas)))
        grp.pending = model.decode_launch(
            grp.features, _make_options(temperatures[0], grp.prompt),
            ts_silence_mask=mask)

    def _group_ts_mask(grp: _Group, idxs):
        """Stack the windows' silence timestamp-token masks, padded to the
        device batch (rows beyond the stack repeat the last row)."""
        if not suppress_ts_tokens:
            return None
        rows = [grp.metas[i]['ts_mask'] for i in idxs]
        from .stabilization import _TS_MASK_LEN
        rows = [(r if r is not None else np.zeros(_TS_MASK_LEN, bool))
                for r in rows]
        if not rows:
            return None
        rows = rows + [rows[-1]] * (batch_size - len(rows))
        return np.stack(rows)

    def _make_options(t: float, prompt) -> DecodingOptions:
        kwargs = dict(decode_options)
        if t > 0:
            kwargs.pop('beam_size', None)
            kwargs.pop('patience', None)
        else:
            kwargs.pop('best_of', None)
        return DecodingOptions(task=task, language=language, temperature=t,
                               prompt=prompt, **kwargs)

    def _needs_fallback(res) -> bool:
        return not decode_acceptable(res, compression_ratio_threshold,
                                     logprob_threshold, no_speech_threshold)

    def finish_decode(grp: _Group):
        """Collect the decode; retry failed windows from the CACHED
        features; segmentize; launch the word-timing pass."""
        nonlocal prompt_reset_since
        n = len(grp.metas)
        results = model.decode_collect(grp.pending, with_features=False)[:n]
        grp.pending = None
        profiling.count('decode.tokens_kept', sum(len(r.tokens) for r in results))
        for t in temperatures[1:]:
            pending_idx = [i for i, r in enumerate(results)
                           if _needs_fallback(r)]
            if not pending_idx:
                break
            # re-decode ONLY the failed windows, from the cached features;
            # rows pad to the next power of two, not the full group
            retry_rows = 1
            while retry_rows < min(len(pending_idx), batch_size):
                retry_rows *= 2
            retry_rows = min(retry_rows, batch_size)
            rows = pending_idx + [pending_idx[-1]] * (retry_rows
                                                      - len(pending_idx))
            # on a mesh decode_launch splits the rows over dp (JAX:
            # shard_batch, batched.py:680)
            feats = grp.features[torch.as_tensor(rows, device=device)]
            mask = _group_ts_mask(grp, pending_idx)
            if mask is not None:
                mask = mask[:retry_rows]
            retry = model.decode(feats, _make_options(t, grp.prompt),
                                 ts_silence_mask=mask, with_features=False)
            for i, r in zip(pending_idx, retry):
                results[i] = r
        grp.results = results
        _t0 = _phase('host_segmentize')
        grp.segments = [_segmentize(res, meta)
                        for res, meta in zip(results, grp.metas)]
        _hp('host_segmentize', _t0)
        if condition_on_previous_text:
            all_tokens.extend(t for segs in grp.segments for s in segs
                              for t in s['tokens'])
            if any(r.temperature is not None and r.temperature > 0.5
                   for r in results):
                prompt_reset_since = len(all_tokens)
        if word_timestamps:
            _t0 = _phase('host_timing_launch')
            grp.timing = _launch_word_timing(
                model, tokenizer, grp.features, grp.metas, grp.segments,
                dynamic_heads, aligner, batch_size, timing_stream,
                gap_padding=gap_padding, split_callback=split_callback)
            _hp('host_timing_launch', _t0)
        grp.features = None

    def _segmentize(res, meta) -> List[dict]:
        """Host: split one window's tokens into segments at timestamp pairs
        (the sequential driver's rules, original_whisper.py:550-602)."""
        time_offset = meta['seek'] / SAMPLE_RATE
        segment_duration = meta['samples'] / SAMPLE_RATE
        tokens = np.array(res.tokens)
        ts_begin = tokenizer.timestamp_begin

        if no_speech_threshold is not None:
            should_skip = res.no_speech_prob > no_speech_threshold
            if (logprob_threshold is not None
                    and res.avg_logprob > logprob_threshold):
                should_skip = False
            if should_skip:
                return []

        def new_segment(start, end, seg_tokens):
            seg_tokens = [int(x) for x in seg_tokens]
            return {
                'seek': round(time_offset, 3),
                'start': start, 'end': end,
                'text': tokenizer.decode([x for x in seg_tokens
                                          if x < tokenizer.eot]),
                'tokens': seg_tokens,
                'temperature': res.temperature,
                'avg_logprob': res.avg_logprob,
                'compression_ratio': res.compression_ratio,
                'no_speech_prob': res.no_speech_prob,
            }

        current_segments: List[dict] = []
        meta['single_ts_ending'] = False
        if len(tokens):
            spans, tail_pos, meta['single_ts_ending'] = timestamp_spans(
                tokens, ts_begin)
            if spans:
                current_segments = [new_segment(
                    round(time_offset + (int(sp[0]) - ts_begin)
                          * time_precision, 3),
                    round(time_offset + min((int(sp[-1]) - ts_begin)
                                            * time_precision,
                                            segment_duration), 3),
                    sp) for sp in spans]
            else:
                duration = (min(tail_pos * time_precision, segment_duration)
                            if tail_pos > 0 else segment_duration)
                current_segments = [new_segment(
                    round(time_offset, 3),
                    round(time_offset + duration, 3), tokens)]

        for i in reversed(range(len(current_segments))):
            seg = current_segments[i]
            if seg['text'].strip() in punctuations or \
                    (word_timestamps and seg['start'] == seg['end']):
                del current_segments[i]
        return current_segments

    def finish_group(grp: _Group):
        """Host: wait for the timing pass, assemble words, suppress, emit."""
        if grp.timing is not None:
            _t0 = _phase('host_timing_finish')
            _finish_word_timing(model, grp.timing, grp.metas, grp.segments,
                                prepend_punctuations, append_punctuations,
                                min_word_dur)
            _hp('host_timing_finish', _t0)
            grp.timing = None
        _t0 = _phase('host_assemble_suppress')
        for meta, segs in zip(grp.metas, grp.segments):
            if word_timestamps:
                segs = [s for s in segs if s.get('words')
                        and keep_segment_instant_rule(s['words'],
                                                      max_instant_words)]
                if avg_prob_threshold and segs:
                    # reference original_whisper.py:665-674 minus the seek
                    # rewind (see the docstring)
                    all_probs = [w['probability'] for s in segs
                                 for w in s['words']]
                    if (meta.get('single_ts_ending')
                            and np.mean(all_probs) < avg_prob_threshold):
                        segs = []
            for i, seg in enumerate(segs):
                seg_obj = Segment(**seg, ignore_unused_args=True)
                if meta['silence_timings'] is not None:
                    seg_obj = seg_obj.suppress_silence(
                        *meta['silence_timings'],
                        min_word_dur=min_word_dur,
                        word_level=suppress_word_ts,
                        nonspeech_error=nonspeech_error,
                        use_word_position=use_word_position)
                    segs[i] = seg_obj.to_dict()
                if verbose:
                    safe_print(seg_obj.to_display_str())
            all_segments.extend({'id': len(all_segments) + i, **s}
                                for i, s in enumerate(segs))
        _hp('host_assemble_suppress', _t0)
        done = grp.end_sample / SAMPLE_RATE
        progress_update(pbar, done)
        if progress_callback is not None:
            total = total_duration or done
            progress_callback(min(done, total), total)

    # -- run the pipeline ------------------------------------------------------------
    # Stage slots: p_decode awaits finish_decode, p_timing awaits
    # finish_group. Order per iteration (unconditioned): decode(g) ->
    # collect and timing launch of g-1 -> word assembly of g-2; g-1's
    # timing pass runs on the side stream during decode(g + 1).
    p_decode: Optional[_Group] = None
    p_timing: Optional[_Group] = None
    eof = False
    n_groups = 0
    try:
        while True:
            # one pipeline step a span, named for the group it reads
            with profiling.span('batched.group') as step:
                grp = None if eof else read_group()
                if grp is None:
                    eof = True
                else:
                    if step:
                        n = len(grp.metas)
                        step.attrs.update(group=n_groups, rows=n,
                                          padded=batch_size - n)
                    n_groups += 1
                if condition_on_previous_text:
                    # decode(g) needs g-1's text: collect it before launching
                    if p_decode is not None:
                        finish_decode(p_decode)
                    done_grp, p_timing, p_decode = p_timing, p_decode, None
                    if grp is not None:
                        launch_decode(grp)
                        p_decode = grp
                    if done_grp is not None:
                        finish_group(done_grp)
                else:
                    if grp is not None:
                        launch_decode(grp)
                    if p_decode is not None:
                        finish_decode(p_decode)
                    if p_timing is not None:
                        finish_group(p_timing)
                    p_timing, p_decode = p_decode, grp
            if eof and p_decode is None and p_timing is None:
                break
        progress_update(pbar, total_duration or 0.0)
    finally:
        pbar.close()
        loader.terminate()

    predictor.finalize_timings()

    if tokenizer is None:  # nothing decodable (all-silent or empty input)
        result = WhisperResult(dict(text='', segments=[], language=language))
        if predictor.nonspeech_timings:
            result.update_nonspeech_sections(*predictor.nonspeech_timings)
        warnings.warn(f'Failed to {task} audio. Result contains no text.')
        return result

    _t0 = _phase('host_result_build')
    text = ''.join(s['text'] for s in all_segments)
    final_result = WhisperResult(
        dict(text=text, segments=all_segments, language=language),
        force_order=not word_timestamps)
    _hp('host_result_build', _t0)

    final_nonspeech_timings = (predictor.nonspeech_timings
                               if suppress_silence else None)
    if resume is not None:
        # merge rules mirror the sequential driver (transcribe.py)
        if len(resume.segments):
            if len(final_result.segments):
                if resume.has_words:
                    resume.fill_in_gaps(final_result, verbose=False)
                else:
                    max_resume_end = final_result[0].start
                    while (len(resume.segments)
                           and resume[-1].end > max_resume_end):
                        del resume[-1]
                    resume.segments.extend(final_result.segments)
                    resume.reassign_ids()
            if final_nonspeech_timings:
                resume.update_nonspeech_sections(*final_nonspeech_timings,
                                                 overwrite=False)
            final_result = resume
        else:
            ns_starts = [s['start'] for s in resume.nonspeech_sections]
            ns_ends = [s['end'] for s in resume.nonspeech_sections]
            if final_nonspeech_timings:
                ns_starts.extend(final_nonspeech_timings[0])
                ns_ends.extend(final_nonspeech_timings[1])
            final_result.update_nonspeech_sections(ns_starts, ns_ends)
    elif final_nonspeech_timings is not None:
        final_result.update_nonspeech_sections(*final_nonspeech_timings)
    if word_timestamps and regroup:
        _t0 = _phase('host_regroup')
        final_result.regroup(regroup)
        _hp('host_regroup', _t0)
    if progress_callback is not None and total_duration:
        progress_callback(total_duration, total_duration)
    if len(final_result.text) == 0:
        warnings.warn(f'Failed to {task} audio. Result contains no text.')
    return final_result


# -- batched word timing ---------------------------------------------------------------


@torch.inference_mode()
def _launch_word_timing(model, tokenizer, features, metas,
                        per_window_segments, dynamic_heads, aligner,
                        batch_size: int, stream=None, gap_padding: str = ' ...',
                        split_callback=None):
    """Queue one padded teacher-forced QK pass for the group, its head
    scoring and the group's DTW costs (batched.py:911-1046); on the card
    on ``stream``, after an event on the current stream, with the token
    probabilities and the costs copied into pinned host memory.

    Right-padding the token rows is exact: under the causal mask, padding
    after a window's real tokens cannot change its tokens' logits or
    attention rows. Returns the queued work and the host bookkeeping for
    :func:`_finish_word_timing`, or None if no window produced segments."""
    prep = []
    for segs in per_window_segments:
        if not segs:
            prep.append(None)
            continue
        for seg in segs:
            seg['words'] = []
        text_tokens, token_split, seg_indices = split_word_tokens(
            segs, tokenizer, padding=gap_padding,
            split_callback=split_callback)
        prep.append((text_tokens, token_split, seg_indices)
                    if text_tokens else None)

    todo = [i for i, p in enumerate(prep) if p is not None]
    if not todo:
        return None
    sot_seq = list(tokenizer.sot_sequence)
    sot_len = len(sot_seq)
    max_len = max(len(prep[i][0]) for i in todo)
    padded_len = _bucket(sot_len + 1 + max_len + 1, 64)

    rows = []
    for i in todo:
        row = (sot_seq + [tokenizer.no_timestamps] + list(prep[i][0])
               + [tokenizer.eot])
        rows.append(row + [tokenizer.eot] * (padded_len - len(row)))
    tokens_arr = np.asarray(rows, np.int64)

    # Legacy mode with known heads: capture only the selected heads' QK
    # rows, (L, B, slots, T, 1500) instead of every head
    legacy_known = (aligner == 'legacy' and not isinstance(aligner, dict)
                    and model.alignment_heads is not None and not dynamic_heads)
    max_qk_lens = [round(metas[i]['samples'] / N_SAMPLES_PER_TOKEN)
                   for i in todo]
    row_counts = [len(prep[i][0]) + 1 for i in todo]  # n_text + 1
    # pad to the device batch: repeat the last real window and token row,
    # with sentinel lengths 1 (their DTW walks are never read)
    pad = batch_size - len(todo)
    pos = todo + [todo[-1]] * pad
    tok_rows = list(range(len(todo))) + [len(todo) - 1] * pad
    rows_in = row_counts + [1] * pad
    qk_lens_in = max_qk_lens + [1] * pad
    # on a mesh this rank scores rows [lo, hi) of the padded batch
    _, lo, hi = batch_rows(batch_size, model.mesh)

    device = features.device
    out = dict(prep=prep, todo=todo, sot_len=sot_len,
               max_qk_lens=max_qk_lens, row_counts=row_counts,
               aligner_mode=aligner, dynamic_heads=dynamic_heads,
               stream=stream, ready=None, batch_size=batch_size)
    if stream is not None:
        stream.wait_stream(torch.cuda.current_stream(device))
        features.record_stream(stream)
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        # every upload before the first kernel: a copy from pageable memory
        # waits for the stream it is queued on. On a mesh, this rank's rows
        # (JAX: shard_batch, batched.py:972-973)
        pos_in, _ = model.shard_batch(np.asarray(pos))
        tokens_in, _ = model.shard_batch(tokens_arr[tok_rows])
        if legacy_known:
            capture_index, slots = build_head_capture_table(
                model.alignment_heads, model.dims.n_text_layer)
            lens_in, _ = model.shard_batch(np.asarray(qk_lens_in))
            counts_in, _ = model.shard_batch(np.asarray(rows_in))
            slots_in = torch.as_tensor(slots, device=device)
            # every window, full or short, takes the batched weights: the
            # reflect continuation reproduces the reference's crop-first
            # filter (timing.py:legacy_weights_batched)
            probs, cost = known_heads_pass(
                model.params.decoder, tokens_in, features[pos_in],
                capture_index, slots_in, lens_in, counts_in, sot_len,
                tokenizer.eot)
        else:
            # the full capture (dynamic heads, the 'new' aligner, unknown
            # heads): scored one window at a time on the device; the
            # capture never leaves it
            logits, qks = decoder_apply(model.params.decoder, tokens_in,
                                        features[pos_in], capture_qk=True)
            probs = _next_token_probs(logits, tokens_in, tokenizer.eot)
            del logits
            matrices = [_device_matrix(model, qks, k, max_qk_lens[g],
                                       row_counts[g], sot_len, None,
                                       dynamic_heads, aligner)
                        for k, g in _local_windows(lo, hi, len(todo))]
            matrices += [matrices[-1]] * (hi - lo - len(matrices))
            mats = torch.stack(matrices)
            del matrices
            if _dynamic_iterations(dynamic_heads, aligner) > 1:
                out['qks_dev'] = qks  # kept for the refinement passes
            del qks
            cost = dtw_cost(-mats)
            del mats
        # per-position probability of the realized next token: the only
        # thing the word assembly needs from the logits
        out['tok_probs'] = _to_host(model.gather_batch(probs))
        out['cost'] = _to_host(model.gather_batch(cost))
        del probs, cost
        if stream is not None:
            out['ready'] = torch.cuda.Event()
            out['ready'].record(stream)
    return out


def _local_windows(lo: int, hi: int, n_todo: int):
    """(local row, window) of the real windows among a rank's rows
    [lo, hi) of the padded timing batch; a rank holding only padding rows
    (copies of the last window) scores the last window once."""
    return [(k, g) for k, g in enumerate(range(lo, hi))
            if g < n_todo] or [(0, n_todo - 1)]


def _dynamic_iterations(dynamic_heads, aligner) -> int:
    """Iteration count of the iterated dynamic-head refinement (reference
    timing.py:254-265: 'count,iterations' string form)."""
    if aligner != 'legacy' or isinstance(aligner, dict):
        return 1
    return parse_dynamic_heads(dynamic_heads)[1]


def _device_matrix(model, qks, k: int, qk_len: int, row_count: int,
                   sot_len: int, peaks, dynamic_heads, aligner):
    """One window's head-scored alignment matrix, computed on the device
    from the resident (L, B, H, T, 1500) capture (the sequential driver's
    dispatch rules, timing.py:find_alignment)."""
    qk = qks[:, k]
    if aligner != 'legacy' or isinstance(aligner, dict):
        kwargs = dict(topk=20, w_colnorm=1.0, w_rownorm=1.0, w_coverage=0.0)
        if isinstance(aligner, dict):
            kwargs.update(aligner)
        return new_aligner_matrix_device(
            qk, qk_len, row_count, sot_len, 1.0, medfilt_width=7,
            topk=min(int(kwargs['topk']),
                     model.dims.n_text_layer * model.dims.n_text_head),
            w_colnorm=float(kwargs['w_colnorm']),
            w_rownorm=float(kwargs['w_rownorm']),
            w_coverage=float(kwargs['w_coverage']))
    # unknown-heads windows reach here with dynamic_heads=None -> default 6
    count = parse_dynamic_heads(dynamic_heads or True)[0]
    return dynamic_weights_device(qk, qk_len, row_count, peaks, sot_len, 1.0,
                                  medfilt_width=7, heads_count=count)


def _finish_word_timing(model, pending, metas, per_window_segments,
                        prepend_punctuations, append_punctuations,
                        min_word_dur):
    """Wait for the queued timing work, walk the DTW tracebacks on the host
    and attach each window's words to its segments (batched.py:1087-1207)."""
    prep, todo = pending['prep'], pending['todo']
    sot_len = pending['sot_len']
    max_qk_lens, row_counts = pending['max_qk_lens'], pending['row_counts']
    n_todo = len(todo)
    if pending['ready'] is not None:
        with profiling.span('timing.wait'):
            pending['ready'].synchronize()
    tok_probs_all = pending['tok_probs'].numpy()[:n_todo]
    jumps_np = dtw_jumps_batched(pending['cost'].numpy()[:n_todo], row_counts,
                                 max_qk_lens)
    iters = _dynamic_iterations(pending['dynamic_heads'],
                                pending['aligner_mode'])
    if iters > 1:
        qks = pending.pop('qks_dev')
        stream = pending['stream']
        with torch.inference_mode(), (torch.cuda.stream(stream) if stream is not None
                                      else contextlib.nullcontext()):
            for _ in range(iters - 1):
                # iterated dynamic refinement (reference timing.py:254-265):
                # midpoints of the previous jumps become the peak targets
                t_rows = qks.shape[-2] - sot_len - 1
                matrices = []
                _, lo, hi = batch_rows(pending['batch_size'], model.mesh)
                for k, g in _local_windows(lo, hi, n_todo):
                    ji = np.pad(jumps_np[g, :row_counts[g]], (0, 1),
                                constant_values=max_qk_lens[g])
                    peaks = np.zeros(t_rows, np.float32)
                    peaks[:row_counts[g]] = ji[:-1] + (ji[1:] - ji[:-1]) * 0.5
                    matrices.append(_device_matrix(
                        model, qks, k, max_qk_lens[g], row_counts[g], sot_len,
                        torch.from_numpy(peaks).to(qks.device),
                        pending['dynamic_heads'], pending['aligner_mode']))
                # pad to the device batch: one DTW launch a pass
                matrices += [matrices[-1]] * (qks.shape[1] - len(matrices))
                cost = model.gather_batch(
                    dtw_cost(-torch.stack(matrices))).cpu().numpy()
                jumps_np = dtw_jumps_batched(cost[:n_todo], row_counts,
                                             max_qk_lens)
        del qks

    for k, i in enumerate(todo):
        text_tokens, (words, word_tokens), seg_indices = prep[i]
        n_text = len(text_tokens)
        alignment = words_from_jumps(
            words, word_tokens, jumps_np[k, :row_counts[k]],
            tok_probs_all[k, sot_len:sot_len + n_text].tolist())
        attach_words(per_window_segments[i], alignment, seg_indices,
                     metas[i]['seek'] / SAMPLE_RATE, min_word_dur,
                     prepend_punctuations, append_punctuations)
