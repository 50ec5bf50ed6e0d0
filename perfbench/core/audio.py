"""Speech-shaped audio made on the device from a seed.

The recipe of the port's ``audio/synth.py:synth_speech_like`` (band-limited
noise bursts of 1-6 s separated by 0.2-1.5 s pauses, amplitude-modulated at
a syllable rate of 3-5 Hz, band-passed to 120-4000 Hz, int16 PCM), with two
changes: the seed is the caller's, and the noise, the band-pass and the
envelope are computed on the card in a few large calls (the band-pass as
the 4th-order Butterworth magnitude applied in the frequency domain, over
a zero-padded length of small prime factors), so
that an hour of audio takes a fraction of a second. No 30-s stretch is
silent: a pause lasts at most 1.5 s.
"""
from dataclasses import dataclass

import numpy as np
import torch

SR = 16000


@dataclass
class Speech:
    pcm: np.ndarray          # int16 (samples,)
    voiced_s: float          # seconds inside bursts
    bursts: np.ndarray       # (n, 2) int64 [start, end) samples

    @property
    def seconds(self) -> float:
        return len(self.pcm) / SR


def seed_words(seed) -> list:
    """A SeedSequence entropy list of an int, a string, or a tuple of
    those (a string counts as the integer of its UTF-8 bytes)."""
    parts = seed if isinstance(seed, (tuple, list)) else (seed,)
    return [int.from_bytes(p.encode(), 'little') if isinstance(p, str)
            else int(p) for p in parts]


def _layout(rng: np.random.Generator, total: int):
    """Bursts [start, end) and their modulation frequency and phase."""
    starts, ends, freqs, phases = [], [], [], []
    pos = 0
    while pos < total:
        burst = min(int(rng.uniform(1.0, 6.0) * SR), total - pos)
        starts.append(pos)
        ends.append(pos + burst)
        freqs.append(rng.uniform(3, 5))
        phases.append(rng.uniform(0, 6.28))
        pos += burst + int(rng.uniform(0.2, 1.5) * SR)
    return (np.array(starts, np.int64), np.array(ends, np.int64),
            np.array(freqs, np.float32), np.array(phases, np.float32))


def _smooth(n: int) -> int:
    """The least length >= n whose only prime factors are 2, 3 and 5 (a
    transform of any other length can fail in cuFFT: a 26-million-point
    one with a large prime factor raised CUFFT_INTERNAL_ERROR)."""
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            m = p35
            while m < n:
                m *= 2
            best = min(best, m)
            p35 *= 3
        p5 *= 5
    return best


def _bandpass_gain(n: int, device) -> torch.Tensor:
    f = torch.fft.rfftfreq(n, d=1.0 / SR, device=device, dtype=torch.float64)
    f = f.clamp(min=1e-3)
    low = 1.0 / torch.sqrt(1.0 + (120.0 / f) ** 8)
    high = 1.0 / torch.sqrt(1.0 + (f / 4000.0) ** 8)
    return (low * high).float()


def speech_like(seconds: float, seed, device) -> Speech:
    """``seconds`` of speech-shaped int16 PCM drawn from ``seed`` (see
    :func:`seed_words`), computed on ``device``."""
    seq = np.random.SeedSequence(seed_words(seed))
    rng = np.random.default_rng(seq)
    total = int(seconds * SR)
    starts, ends, freqs, phases = _layout(rng, total)
    gen = torch.Generator(device=device).manual_seed(
        int(seq.generate_state(1, np.uint64)[0] >> np.uint64(1)))
    noise = torch.randn(total, generator=gen, device=device)
    n_fft = _smooth(total)
    spec = torch.fft.rfft(noise, n=n_fft)
    spec *= _bandpass_gain(n_fft, device)
    band = torch.fft.irfft(spec, n=n_fft)[:total]
    del noise, spec
    lengths = torch.from_numpy(ends - starts).to(device)
    burst_of = torch.repeat_interleave(
        torch.arange(len(starts), device=device), lengths)
    offset = (torch.arange(len(burst_of), device=device)
              - torch.repeat_interleave(torch.cumsum(lengths, 0) - lengths,
                                        lengths))
    pos = torch.from_numpy(starts).to(device)[burst_of] + offset
    t = offset.float() / SR
    env = 0.55 + 0.45 * torch.sin(
        2 * np.pi * torch.from_numpy(freqs).to(device)[burst_of] * t
        + torch.from_numpy(phases).to(device)[burst_of])
    out = torch.zeros(total, device=device)
    out[pos] = band[pos] * env * 0.15
    pcm = (out.clamp(-1.0, 1.0) * 32767.0).round().to(torch.int16).cpu().numpy()
    return Speech(pcm=pcm, voiced_s=float((ends - starts).sum()) / SR,
                  bursts=np.stack([starts, ends], 1))
