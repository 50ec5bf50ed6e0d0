"""Built-in energy/spectral-entropy VAD (offline Silero substitute).

The reference's VAD option requires downloading Silero via torch.hub
(stabilization/silero_vad.py). Air-gapped deployments need a local option:
this VAD scores 512-sample windows by band-limited speech energy and
spectral flatness, producing probabilities in [0, 1] compatible with the
``NonSpeechPredictor`` VAD interface (pass ``vad={'model':
EnergyVAD()}``, or ``vad='energy'`` through the drivers).
"""
from typing import Optional

import numpy as np


class EnergyVAD:
    """Callable (chunk_float32[window], sr) -> speech probability.

    Stateful normalization: tracks a running noise floor so probabilities
    adapt to the recording level (reset with :meth:`reset_states`).
    """

    def __init__(self, floor_decay: float = 0.995, gain: float = 12.0):
        self.floor_decay = floor_decay
        self.gain = gain
        self.reset_states()

    def reset_states(self):
        self._noise_floor: Optional[float] = None

    def __call__(self, chunk: np.ndarray, sr: int) -> float:
        chunk = np.asarray(chunk, np.float32)
        if chunk.size == 0:
            return 0.0
        spec = np.abs(np.fft.rfft(chunk * np.hanning(chunk.size)))
        freqs = np.fft.rfftfreq(chunk.size, 1.0 / sr)
        band = (freqs >= 80) & (freqs <= 4000)
        band_energy = float(np.sqrt((spec[band] ** 2).mean() + 1e-12))

        if self._noise_floor is None:
            self._noise_floor = band_energy
        else:
            # Track the floor downward fast, upward slowly.
            if band_energy < self._noise_floor:
                self._noise_floor = band_energy
            else:
                self._noise_floor = (self.floor_decay * self._noise_floor
                                     + (1 - self.floor_decay) * band_energy)
        snr = band_energy / (self._noise_floor + 1e-10)

        # Spectral flatness: speech is peaky (low flatness), noise is flat.
        p = spec[band] ** 2
        p = p / (p.sum() + 1e-12)
        geo = np.exp(np.log(p + 1e-12).mean())
        arith = p.mean() + 1e-12
        flatness = float(geo / arith)

        score = np.log1p(max(snr - 1.0, 0.0)) * (1.0 - flatness)
        return float(np.clip(score * self.gain / 10.0, 0.0, 1.0))
