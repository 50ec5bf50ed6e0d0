"""Audio writing (WAV via stdlib; counterpart of reference audio/output.py)."""
import wave
from typing import List, Optional, Tuple

import numpy as np

from ..constants import SAMPLE_RATE


def save_audio(audio: np.ndarray, path: str, sr: int = SAMPLE_RATE,
               muted_sections: Optional[List[Tuple[float, float]]] = None):
    """Write mono float32 audio to a 16-bit WAV file.

    ``muted_sections``: optional (start, end) second-ranges; when given, the
    output has two channels — original on the left, with the sections muted
    on the right (mirrors reference audio/output.py:40-52 channel split).
    """
    audio = np.asarray(audio, np.float32)
    if muted_sections:
        right = audio.copy()
        for start, end in muted_sections:
            right[int(start * sr):int(end * sr)] = 0.0
        stacked = np.stack([audio, right], axis=-1)
        data = (np.clip(stacked, -1, 1) * 32767).astype('<i2')
        n_channels = 2
    else:
        data = (np.clip(audio, -1, 1) * 32767).astype('<i2')
        n_channels = 1
    if not path.lower().endswith('.wav'):
        path += '.wav'
    with wave.open(path, 'wb') as w:
        w.setnchannels(n_channels)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return path
