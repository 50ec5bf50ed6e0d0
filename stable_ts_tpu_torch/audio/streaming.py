"""Streaming audio sources: bounded-memory decode of arbitrarily long files.

Counterpart of the reference's ffmpeg-pipe streaming
(audio/__init__.py:552-591): audio is decoded incrementally so hour-long (or
live) sources never materialize in RAM. Two readers:

- :class:`WavStreamReader` — stdlib ``wave`` chunk reads (PCM 8/16/24/32-bit,
  any channel count), no external binaries.
- :class:`FfmpegStreamReader` — ``ffmpeg -f s16le -ac 1 -ar 16000 pipe:``
  like the reference, for every other container (gated on ffmpeg on PATH).

Both emit float32 mono; :class:`ChunkedResampler` converts arbitrary source
rates to 16 kHz statefully (polyphase with context margins and exact
rational output bookkeeping — no gaps or overlaps across chunk boundaries).
"""
import shutil
import subprocess
import wave
from fractions import Fraction
from math import gcd
from typing import Optional

import numpy as np

from ..constants import SAMPLE_RATE


class ChunkedResampler:
    """Stateful streaming resampler (polyphase, scipy) with exact output
    accounting: concatenating the emitted chunks equals one-shot resampling
    up to filter edge effects at the (bounded) context margins."""

    def __init__(self, in_sr: int, out_sr: int, margin: int = 512):
        g = gcd(in_sr, out_sr)
        self.up = out_sr // g
        self.down = in_sr // g
        self.ratio = Fraction(self.up, self.down)
        self.margin = margin
        self._context = np.zeros(0, np.float32)   # emitted input kept as left context
        self._pending = np.zeros(0, np.float32)   # input not yet emitted
        self._consumed = 0                        # absolute input samples emitted
        self._emitted_out = 0                     # absolute output samples emitted

    def _out_pos(self, in_pos: int) -> int:
        return int(in_pos * self.up // self.down)

    def feed(self, block: Optional[np.ndarray], final: bool = False) -> np.ndarray:
        from scipy.signal import resample_poly
        if block is not None and block.size:
            self._pending = np.concatenate([self._pending,
                                            np.asarray(block, np.float32)])
        if self.up == self.down:
            out = self._pending
            self._pending = np.zeros(0, np.float32)
            self._consumed += out.size
            self._emitted_out += out.size
            return out
        emit_in = (self._pending.size if final
                   else max(0, self._pending.size - self.margin))
        if emit_in == 0 and not final:
            return np.zeros(0, np.float32)
        x = np.concatenate([self._context, self._pending])
        y = resample_poly(x, self.up, self.down)
        ctx_start_abs = self._consumed - self._context.size
        # absolute output range to emit
        out_lo_abs = self._emitted_out
        out_hi_abs = (self._out_pos(self._consumed + emit_in) if not final
                      else int(np.ceil((self._consumed + emit_in)
                                       * self.up / self.down)))
        base = self._out_pos(ctx_start_abs)
        lo = out_lo_abs - base
        hi = min(out_hi_abs - base, y.size)
        out = y[max(lo, 0):hi].astype(np.float32)
        self._consumed += emit_in
        self._emitted_out += out.size
        consumed_local = self._context.size + emit_in
        # context start must stay on a multiple of ``down`` so every
        # resample_poly call sees the same polyphase grid as the absolute
        # stream (otherwise fractional ratios phase-shift at each chunk)
        want_start_abs = max(0, self._consumed - self.margin)
        want_start_abs -= want_start_abs % self.down
        keep = self._consumed - want_start_abs
        keep = min(keep, consumed_local)
        self._context = x[consumed_local - keep:consumed_local]
        self._pending = self._pending[emit_in:]
        return out


def _pcm_to_float(data: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 1:  # unsigned 8-bit
        x = np.frombuffer(data, np.uint8).astype(np.float32)
        x = (x - 128.0) / 128.0
    elif sampwidth == 2:
        x = np.frombuffer(data, '<i2').astype(np.float32) / 32768.0
    elif sampwidth == 3:
        raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
        x = (raw[:, 0].astype(np.int32)
             | (raw[:, 1].astype(np.int32) << 8)
             | (raw[:, 2].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        x = np.frombuffer(data, '<i4').astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f'unsupported PCM sample width: {sampwidth}')
    if n_channels > 1:
        x = x.reshape(-1, n_channels).mean(axis=1)
    return x


class WavStreamReader:
    """Chunked PCM WAV reads via stdlib wave (no external binaries)."""

    def __init__(self, path: str):
        self._wav = wave.open(path, 'rb')
        self.src_sr = self._wav.getframerate()
        self.n_channels = self._wav.getnchannels()
        self.sampwidth = self._wav.getsampwidth()
        self.n_frames = self._wav.getnframes()
        self._path = path

    @property
    def duration(self) -> float:
        return self.n_frames / self.src_sr

    def read(self, n_frames: int) -> Optional[np.ndarray]:
        data = self._wav.readframes(n_frames)
        if not data:
            return None
        return _pcm_to_float(data, self.sampwidth, self.n_channels)

    def restart(self):
        self._wav.rewind()

    def close(self):
        self._wav.close()


class FfmpegStreamReader:
    """ffmpeg subprocess pipe emitting s16le mono 16 kHz (reference
    audio/__init__.py:572-591)."""

    def __init__(self, source: str):
        if shutil.which('ffmpeg') is None:
            raise FileNotFoundError('ffmpeg binary not found on PATH')
        self._source = source
        self.src_sr = SAMPLE_RATE  # ffmpeg resamples in-pipe
        self._spawn()

    def _spawn(self):
        self._proc = subprocess.Popen(
            ['ffmpeg', '-nostdin', '-threads', '0', '-i', self._source,
             '-f', 's16le', '-ac', '1', '-acodec', 'pcm_s16le',
             '-ar', str(SAMPLE_RATE), 'pipe:'],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)

    @property
    def duration(self) -> Optional[float]:
        from .utils import get_metadata
        try:
            return get_metadata(self._source).get('duration')
        except Exception:
            return None

    def read(self, n_frames: int) -> Optional[np.ndarray]:
        data = self._proc.stdout.read(n_frames * 2)
        if not data:
            return None
        return np.frombuffer(data, '<i2').astype(np.float32) / 32768.0

    def restart(self):
        self.close()
        self._spawn()

    def close(self):
        if self._proc.poll() is None:
            self._proc.kill()
        self._proc.wait()
        if self._proc.stdout:
            self._proc.stdout.close()


def open_stream_reader(source: str):
    """Best available streaming reader for a path/URL, or None."""
    if isinstance(source, str) and source.lower().endswith('.wav'):
        try:
            return WavStreamReader(source)
        except (wave.Error, EOFError, FileNotFoundError):
            pass
    if isinstance(source, str) and shutil.which('ffmpeg'):
        try:
            return FfmpegStreamReader(source)
        except Exception:
            return None
    return None
