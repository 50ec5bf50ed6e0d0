"""Chunked audio loading with preprocessing callbacks.

Counterpart of the reference ``AudioLoader`` (audio/__init__.py:152): a
unified source (path / bytes / ndarray), chunked reads aligned to a divisor,
per-chunk preprocessing (denoise, voice-band filter) with a post-prep
callback (used by the VAD to accumulate probabilities), ``load_sections``
(clip timestamps) with negation, and duration metadata.

Two modes:
- eager (default for arrays/bytes, or short files): decode everything up
  front; simplest and allows load_sections/save_path.
- streaming (``stream=True``, or auto for long file paths): bounded-memory
  incremental decode through ``streaming.WavStreamReader`` /
  ``FfmpegStreamReader`` + the stateful ``ChunkedResampler`` — arbitrarily
  long sources never materialize in RAM (reference
  audio/__init__.py:552-591 semantics). Backward seeks within the rolling
  buffer are served directly; older seeks restart the reader.
"""
import warnings
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from .utils import audio_to_numpy_resample, voice_freq_filter
from ..constants import SAMPLE_RATE

# auto-stream threshold: files longer than this stream (seconds)
AUTO_STREAM_SECONDS = 600.0
# streamed decode granularity (source frames per reader read)
_READ_FRAMES = 16000 * 4
# rolling buffer kept behind the newest consumed position (samples @16k):
# covers the aligner's fallback re-seeks (~2 windows) with margin
_KEEP_BEHIND = 16000 * 90


class AudioLoader:

    def __init__(
            self,
            source: Union[str, bytes, np.ndarray],
            buffer_size: Optional[int] = None,
            stream: Optional[bool] = None,
            sr: Optional[int] = None,
            denoiser: Optional[str] = None,
            denoiser_options: Optional[dict] = None,
            only_voice_freq: bool = False,
            only_ffmpeg: bool = False,
            verbose: Optional[bool] = True,
            new_chunk_divisor: Optional[int] = 512,
            save_path: Optional[str] = None,
            load_sections: Optional[List[Tuple[Optional[float], Optional[float]]]] = None,
            negate_load: bool = False,
            post_prep_callback: Optional[Callable] = None,
    ):
        from .source import is_url, load_source
        if is_url(source):
            # file:// -> local path; other URLs -> yt-dlp bytes, or the URL
            # itself (direct link for ffmpeg) when yt-dlp is unavailable or
            # only_ffmpeg is set (reference audio/utils.py:16-60)
            source = load_source(source, verbose=verbose,
                                 only_ffmpeg=only_ffmpeg)
        self._src = source
        self.verbose = verbose
        self.chunk_divisor = new_chunk_divisor
        self._denoiser = denoiser
        self._denoiser_options = denoiser_options or {}
        self._only_voice_freq = only_voice_freq
        self._post_prep_callback = post_prep_callback
        self._prev_seek = 0
        self._finished = False
        self._sr = SAMPLE_RATE
        self._prepped: Optional[np.ndarray] = None
        self._load_mask: Optional[np.ndarray] = None
        self._reader = None
        self._keep_behind = buffer_size or _KEEP_BEHIND

        want_stream = stream
        # features that need the whole waveform force eager mode
        if load_sections or save_path or negate_load:
            if stream:
                warnings.warn('load_sections/save_path require the full '
                              'waveform; falling back to eager loading.')
            want_stream = False
        if want_stream is not False and isinstance(source, str):
            from .streaming import open_stream_reader
            reader = open_stream_reader(source)
            if reader is not None:
                dur = reader.duration
                if want_stream or (dur is None or dur > AUTO_STREAM_SECONDS):
                    self._init_streaming(reader)
                    return
                reader.close()
            elif want_stream:
                warnings.warn(f'no streaming reader available for {source!r} '
                              '(stdlib WAV or ffmpeg); loading eagerly.')

        audio = audio_to_numpy_resample(source, sr, SAMPLE_RATE)
        self._raw = audio
        if load_sections:
            self._load_mask = self._sections_to_mask(load_sections, negate_load,
                                                     len(audio))
        elif negate_load:
            raise ValueError('``negate_load=True`` requires ``load_sections``')
        if save_path:
            self._save(save_path)

    # -- streaming mode ---------------------------------------------------------------

    def _init_streaming(self, reader):
        from .streaming import ChunkedResampler
        self._reader = reader
        self._resampler = ChunkedResampler(reader.src_sr, SAMPLE_RATE)
        self._buf = np.zeros(0, np.float32)   # prepped samples @16 kHz
        self._buf_start = 0                   # absolute index of _buf[0]
        self._stream_eof = False
        dur = reader.duration
        self._est_total = None if dur is None else int(round(dur * SAMPLE_RATE))

    def _prep_block(self, block: np.ndarray) -> np.ndarray:
        if self._denoiser:
            from .denoiser import apply_denoiser
            block = apply_denoiser(self._denoiser, block,
                                   **self._denoiser_options)
        if self._only_voice_freq:
            block = voice_freq_filter(block, self._sr)
        return np.asarray(block, np.float32)

    def _advance_stream(self):
        """Decode + prep one more reader block into the rolling buffer."""
        raw = self._reader.read(_READ_FRAMES)
        out = self._resampler.feed(raw, final=raw is None)
        if raw is None:
            self._stream_eof = True
        if out.size:
            block = self._prep_block(out)
            if self._post_prep_callback is not None:
                self._post_prep_callback(block)
            self._buf = np.concatenate([self._buf, block])

    def _ensure_streamed(self, end: int):
        while not self._stream_eof and self._buf_start + self._buf.size < end:
            self._advance_stream()

    def _restart_stream(self):
        from .streaming import ChunkedResampler
        self._reader.restart()
        self._resampler = ChunkedResampler(self._reader.src_sr, SAMPLE_RATE)
        self._buf = np.zeros(0, np.float32)
        self._buf_start = 0
        self._stream_eof = False
        # VAD prob accumulation restarts from zero too
        if self._post_prep_callback is not None:
            warnings.warn('restarting audio stream for a backward seek '
                          'before the rolling buffer; streaming VAD '
                          'probabilities may be re-appended out of order.')

    def _stream_chunk(self, seek: int, size: Optional[int]) -> Optional[np.ndarray]:
        if seek < self._buf_start:
            self._restart_stream()
        if size is None:
            # read to EOF; bounded by est_total when known, else grow
            if self._est_total is not None:
                size = max(self._est_total - seek, 0)
            else:
                size = 1 << 62
        if self.chunk_divisor:
            size = int(np.ceil(size / self.chunk_divisor) * self.chunk_divisor)
        self._ensure_streamed(seek + size)
        end_abs = self._buf_start + self._buf.size
        if seek >= end_abs:
            self._finished = True
            return None
        lo = seek - self._buf_start
        hi = min(lo + size, self._buf.size)
        chunk = self._buf[lo:hi]
        # drop samples far behind the newest consumed position
        drop = (seek - self._keep_behind) - self._buf_start
        if drop > 0:
            self._buf = self._buf[drop:]
            self._buf_start += drop
        if chunk.size == 0:
            self._finished = True
            return None
        return chunk

    # -- sections -----------------------------------------------------------------

    def _sections_to_mask(self, sections, negate: bool, n: int) -> np.ndarray:
        mask = np.zeros(n, dtype=bool)
        for start, end in sections:
            s = 0 if start is None else max(int(round(start * self._sr)), 0)
            e = n if end is None else min(int(round(end * self._sr)), n)
            if e > s:
                mask[s:e] = True
        return ~mask if negate else mask

    # -- preprocessing ----------------------------------------------------------------

    def _prep(self) -> np.ndarray:
        if self._prepped is None:
            audio = self._raw
            if self._denoiser:
                from .denoiser import apply_denoiser
                audio = apply_denoiser(self._denoiser, audio,
                                       **self._denoiser_options)
            if self._only_voice_freq:
                audio = voice_freq_filter(audio, self._sr)
            self._prepped = audio
            if self._post_prep_callback is not None:
                self._post_prep_callback(self._prepped)
        return self._prepped

    def update_post_prep_callback(self, callback: Optional[Callable]):
        self._post_prep_callback = callback
        if callback is None:
            return
        if self._reader is not None:
            if self._buf.size:
                callback(self._buf)
        elif self._prepped is not None:
            callback(self._prepped)

    # -- reading ---------------------------------------------------------------------------

    @property
    def stream(self) -> bool:
        return self._reader is not None

    @property
    def sr(self) -> int:
        return self._sr

    def get_duration(self, ndigits: Optional[int] = None) -> float:
        if self._reader is not None:
            if self._est_total is not None:
                dur = self._est_total / self._sr
            else:
                dur = (self._buf_start + self._buf.size) / self._sr
        else:
            dur = len(self._raw) / self._sr
        return round(dur, ndigits) if ndigits is not None else dur

    def next_chunk(self, seek: int, size: Optional[int] = None) -> Optional[np.ndarray]:
        """Samples [seek, seek+size); None at EOF. Size aligned to divisor."""
        if self._reader is not None:
            return self._stream_chunk(seek, size)
        audio = self._prep()
        if seek >= len(audio):
            self._finished = True
            return None
        if size is None:
            size = len(audio) - seek
        if self.chunk_divisor:
            size = int(np.ceil(size / self.chunk_divisor) * self.chunk_divisor)
        chunk = audio[seek:seek + size]
        if chunk.size == 0:
            self._finished = True
            return None
        return chunk

    def next_valid_chunk(self, seek: int, size: Optional[int] = None
                         ) -> Tuple[Optional[np.ndarray], int]:
        """Like next_chunk but skips samples excluded by load_sections.

        Returns (chunk, adjusted_seek).
        """
        if self._load_mask is None or self._reader is not None:
            return self.next_chunk(seek, size), seek
        n = len(self._raw)
        while seek < n and not self._load_mask[seek]:
            nxt = np.flatnonzero(self._load_mask[seek:])
            if len(nxt) == 0:
                return None, seek
            seek = seek + int(nxt[0])
        if seek >= n:
            return None, seek
        chunk = self.next_chunk(seek, size)
        if chunk is None:
            return None, seek
        # Trim the chunk at the end of the current valid section.
        section = self._load_mask[seek:seek + len(chunk)]
        invalid = np.flatnonzero(~section)
        if len(invalid):
            chunk = chunk[:invalid[0]]
            if chunk.size == 0:
                return None, seek
        return chunk, seek

    def _save(self, path: str):
        from .output import save_audio
        save_audio(self._prep(), path, self._sr)

    def terminate(self):
        if self._reader is not None:
            self._reader.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.terminate()
