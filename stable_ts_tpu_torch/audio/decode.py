"""Audio decoding front door.

Decodes audio files/bytes to mono float32. WAV decodes via the stdlib;
FLAC and other formats use the native C++ decoder in
:mod:`stable_ts_tpu_torch.native` (built on demand). The reference shells out to
ffmpeg for this (audio/utils.py:63-125); this build is self-contained.
"""
import io
import os
import struct
from typing import Optional, Tuple, Union

import numpy as np


def _decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    import wave
    with wave.open(io.BytesIO(data), 'rb') as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        frames = w.readframes(w.getnframes())
    if sampwidth == 2:
        audio = np.frombuffer(frames, dtype='<i2').astype(np.float32) / 32768.0
    elif sampwidth == 4:
        audio = np.frombuffer(frames, dtype='<i4').astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        audio = (np.frombuffer(frames, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:
        raw = np.frombuffer(frames, dtype=np.uint8).reshape(-1, 3)
        as_int = (raw[:, 0].astype(np.int32)
                  | (raw[:, 1].astype(np.int32) << 8)
                  | (raw[:, 2].astype(np.int32) << 16))
        as_int = np.where(as_int >= 1 << 23, as_int - (1 << 24), as_int)
        audio = as_int.astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f'unsupported WAV sample width: {sampwidth}')
    if n_channels > 1:
        audio = audio.reshape(-1, n_channels).mean(axis=1)
    return audio, sr


def decode_audio(source: Union[str, bytes], sr: Optional[int] = None
                 ) -> Tuple[np.ndarray, int]:
    """Decode ``source`` (path or bytes) -> (mono float32, native sample rate).

    If ``sr`` is given, resample to it.
    """
    if isinstance(source, str):
        with open(source, 'rb') as f:
            data = f.read()
    else:
        data = source

    if data[:4] == b'RIFF' and data[8:12] == b'WAVE':
        audio, native_sr = _decode_wav(data)
    elif data[:4] == b'fLaC':
        from ..native import flac_decode
        audio, native_sr = flac_decode(data)
    else:
        raise ValueError(
            'unsupported audio container (built-in decoders: WAV, FLAC). '
            'Decode to WAV first or pass a waveform array.')

    if sr is not None and sr != native_sr:
        from .utils import resample
        audio = resample(audio, native_sr, sr)
        native_sr = sr
    return audio.astype(np.float32), native_sr


def get_metadata(source: Union[str, bytes]) -> dict:
    """Best-effort duration/sample-rate probe without full decode."""
    if isinstance(source, str):
        with open(source, 'rb') as f:
            head = f.read(65536)
    else:
        head = source[:65536]
    if head[:4] == b'RIFF' and head[8:12] == b'WAVE':
        # fmt chunk: channels @22, sr @24; data size from RIFF size approx.
        try:
            n_channels = struct.unpack_from('<H', head, 22)[0]
            sr = struct.unpack_from('<I', head, 24)[0]
            bits = struct.unpack_from('<H', head, 34)[0]
            total = (os.path.getsize(source) if isinstance(source, str)
                     else len(source))
            data_bytes = max(total - 44, 0)
            duration = data_bytes / (sr * n_channels * (bits // 8))
            return dict(sr=sr, duration=duration)
        except Exception:
            return dict(sr=None, duration=None)
    if head[:4] == b'fLaC':
        # STREAMINFO: sample rate 20 bits at offset 18 of block, total samples
        # 36 bits following.
        try:
            block = head[8:8 + 34]
            sr = (block[10] << 12) | (block[11] << 4) | (block[12] >> 4)
            total_samples = (((block[13] & 0x0F) << 32) | (block[14] << 24)
                             | (block[15] << 16) | (block[16] << 8) | block[17])
            duration = total_samples / sr if sr else None
            return dict(sr=sr, duration=duration)
        except Exception:
            return dict(sr=None, duration=None)
    return dict(sr=None, duration=None)
