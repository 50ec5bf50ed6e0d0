"""Log-mel spectrogram in PyTorch (port of stable_ts_tpu/ops/mel.py).

Whisper's front end: centered STFT (N_FFT=400, hop=160, periodic Hann),
power spectrum with the last frame dropped, slaney mel filterbank, log10
clamped at 1e-10, dynamic range compressed to [~-1, ~1]. As in the JAX
package the windowed DFT is one matrix product against a Hann-windowed
cos/sin basis and the filterbank is generated analytically, so both
packages multiply by the same f32 matrices. Plain torch: it is two
matrix products and elementwise work, no kernel of its own.
"""
from functools import lru_cache

import numpy as np
import torch

from stable_ts_tpu.constants import HOP_LENGTH, N_FFT, SAMPLE_RATE


def _hz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(freq >= min_log_hz,
                    min_log_mel + np.log(np.maximum(freq, min_log_hz)
                                         / min_log_hz) / logstep,
                    freq / f_sp)


def _mel_to_hz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mels >= min_log_mel,
                    min_log_hz * np.exp(logstep * (mels - min_log_mel)),
                    f_sp * mels)


@lru_cache(maxsize=4)
def mel_filterbank(n_mels: int = 80, n_fft: int = N_FFT,
                   sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-scale, slaney-normalized triangular filterbank (librosa's
    ``filters.mel(htk=False, norm='slaney')``). f32 (n_mels, n_fft//2+1)."""
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    mel_points = np.linspace(_hz_to_mel_slaney(0.0),
                             _hz_to_mel_slaney(sample_rate / 2.0), n_mels + 2)
    hz_points = _mel_to_hz_slaney(mel_points)
    fdiff = np.diff(hz_points)
    ramps = hz_points[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_points[2:n_mels + 2] - hz_points[:n_mels]))[:, None]
    return weights.astype(np.float32)


@lru_cache(maxsize=2)
def windowed_dft_basis(n_fft: int = N_FFT) -> np.ndarray:
    """(n_fft, 2*(n_fft//2+1)) f32: periodic Hann folded into the real DFT
    basis, cos columns then sin columns."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    win = (0.5 * (1 - np.cos(2 * np.pi * n / n_fft)))[:, None]
    return np.concatenate([np.cos(ang) * win, np.sin(ang) * win],
                          axis=1).astype(np.float32)


def _as_audio(audio, device) -> torch.Tensor:
    if isinstance(audio, np.ndarray):
        audio = torch.from_numpy(np.ascontiguousarray(audio))
    audio = torch.as_tensor(audio, device=device)
    if audio.dtype == torch.int16:
        # every int16 is exact in f32, so this equals the host's /32768
        return audio.float() / 32768.0
    return audio.float()


def _log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    pad = N_FFT // 2
    padded = torch.nn.functional.pad(audio[:, None], (pad, pad),
                                     mode='reflect')[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)      # (B, n_frames, N_FFT)
    basis = torch.from_numpy(windowed_dft_basis(N_FFT)).to(audio.device)
    filters = torch.from_numpy(mel_filterbank(n_mels)).to(audio.device)
    spec = frames @ basis
    k_bins = N_FFT // 2 + 1
    power = (spec[..., :k_bins] ** 2 + spec[..., k_bins:] ** 2)[:, :-1]
    mel = torch.einsum('bfk,mk->bmf', power, filters)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))
    peak = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, peak - 8.0)
    return (log_spec + 4.0) / 4.0


def log_mel_spectrogram(audio, n_mels: int = 80, padding: int = 0,
                        device=None) -> torch.Tensor:
    """Whisper log-mel of a 1-D or (batch, samples) waveform (numpy or
    torch; int16 PCM is scaled by 1/32768). Runs on ``device`` (default:
    where the tensor lies; numpy input defaults to the CPU). Returns
    (n_mels, frames) or (batch, n_mels, frames) f32."""
    if device is None:
        device = audio.device if isinstance(audio, torch.Tensor) else 'cpu'
    x = _as_audio(audio, device)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    if padding > 0:
        x = torch.nn.functional.pad(x, (0, padding))
    out = _log_mel(x, n_mels)
    return out[0] if squeeze else out


def log_mel_windowed(audio, n_mels: int = 80, n_frames: int = 3000,
                     device=None) -> torch.Tensor:
    """Window mels from SHORT zero-padded rows, equal to padding each row
    to the full window first (see the JAX twin): frames past the rows'
    bucket are pure-zero windows whose value depends only on the row max
    ``m``: ``max(m - 2, -1.5)``. audio: (B, t_bucket) with every row =
    real samples then >= N_FFT zeros. Returns (B, n_mels, n_frames)."""
    if device is None:
        device = audio.device if isinstance(audio, torch.Tensor) else 'cpu'
    mel = _log_mel(_as_audio(audio, device), n_mels)
    f_b = mel.shape[-1]
    if f_b >= n_frames:
        return mel[..., :n_frames]
    rowmax = mel.amax(dim=(-2, -1), keepdim=True)
    tail = torch.clamp(rowmax - 2.0, min=-1.5).expand(
        *mel.shape[:-1], n_frames - f_b)
    return torch.cat([mel, tail], dim=-1)
