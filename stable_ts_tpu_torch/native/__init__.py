"""Native (C++) runtime components, built on demand and loaded via ctypes.

Currently: the FLAC decoder (audioio.cpp). The shared library is compiled on
first use with the system compiler and cached next to the source keyed by a
source hash, so installs need no build step and edits rebuild automatically.
"""
import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_LOCK = threading.Lock()
_LIB = None


def _build_library() -> str:
    src = os.path.join(_HERE, 'audioio.cpp')
    with open(src, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_HERE, f'_audioio_{digest}.so')
    if os.path.exists(out):
        return out
    for stale in os.listdir(_HERE):
        if stale.startswith('_audioio_') and stale.endswith('.so'):
            try:
                os.unlink(os.path.join(_HERE, stale))
            except OSError:
                pass
    cmd = ['g++', '-O2', '-shared', '-fPIC', '-std=c++17', src, '-o', out]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as exc:
        raise RuntimeError('g++ not found; cannot build the native audio '
                           'decoder') from exc
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f'native build failed:\n{exc.stderr}') from exc
    return out


def _load():
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build_library())
            lib.flac_decode.restype = ctypes.c_int
            lib.flac_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.free_samples.argtypes = [ctypes.POINTER(ctypes.c_int32)]
            _LIB = lib
    return _LIB


def flac_decode(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode FLAC bytes -> (mono float32 in [-1, 1], sample_rate)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_int32)()
    n_frames = ctypes.c_int64()
    sr = ctypes.c_int()
    channels = ctypes.c_int()
    bps = ctypes.c_int()
    rc = lib.flac_decode(data, len(data), ctypes.byref(out),
                         ctypes.byref(n_frames), ctypes.byref(sr),
                         ctypes.byref(channels), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f'FLAC decode failed (error {rc})')
    try:
        count = n_frames.value * channels.value
        pcm = np.ctypeslib.as_array(out, shape=(count,)).copy()
    finally:
        lib.free_samples(out)
    scale = float(1 << (bps.value - 1))
    audio = pcm.astype(np.float32) / scale
    if channels.value > 1:
        audio = audio.reshape(-1, channels.value).mean(axis=1)
    return audio, sr.value


def flac_decode_raw(data: bytes) -> Tuple[np.ndarray, int, int, int]:
    """Decode FLAC bytes -> (int32 interleaved frames, sr, channels, bps)."""
    lib = _load()
    out = ctypes.POINTER(ctypes.c_int32)()
    n_frames = ctypes.c_int64()
    sr = ctypes.c_int()
    channels = ctypes.c_int()
    bps = ctypes.c_int()
    rc = lib.flac_decode(data, len(data), ctypes.byref(out),
                         ctypes.byref(n_frames), ctypes.byref(sr),
                         ctypes.byref(channels), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f'FLAC decode failed (error {rc})')
    try:
        count = n_frames.value * channels.value
        pcm = np.ctypeslib.as_array(out, shape=(count,)).copy()
    finally:
        lib.free_samples(out)
    return pcm, sr.value, channels.value, bps.value
