"""A seeded speech-shaped test signal (the same function, seed and output as
``synth_speech_like`` in the repository's ``bench.py``), so the port's GPU
smoke run drives the benchmark's audio without importing its driver."""
import numpy as np


def synth_speech_like(seconds: float, sr: int = 16000) -> np.ndarray:
    """Speech-shaped test signal: band-limited noise bursts with pauses.

    Bursts of 1-6 s separated by 0.2-1.5 s silences, amplitude-modulated at
    syllable rate (~4 Hz), band-passed to the voice band — enough structure
    that VAD/suppression and segment splitting do real work. Returned as
    int16 PCM, the wire format real audio arrives in.
    """
    from scipy.signal import butter, sosfilt
    rng = np.random.default_rng(0)
    total = int(seconds * sr)
    out = np.zeros(total, np.float32)
    sos = butter(4, [120, 4000], btype='bandpass', fs=sr, output='sos')
    pos = 0
    while pos < total:
        burst = int(rng.uniform(1.0, 6.0) * sr)
        burst = min(burst, total - pos)
        noise = rng.standard_normal(burst)
        t = np.arange(burst) / sr
        envelope = 0.55 + 0.45 * np.sin(2 * np.pi * rng.uniform(3, 5) * t
                                        + rng.uniform(0, 6.28))
        out[pos:pos + burst] = sosfilt(sos, noise) * envelope * 0.15
        pos += burst + int(rng.uniform(0.2, 1.5) * sr)
    return (np.clip(out, -1.0, 1.0) * 32767.0).round().astype(np.int16)
