"""Engine-agnostic cores: any ASR backend plugs in via ``inference_func``.

The stabilizing algorithms (forced alignment with fallback, mute-and-bisect
refinement, adapter transcription) are model-independent; the Whisper
glue in :mod:`stable_ts_tpu_torch.alignment` is just one backend.
"""
from .alignment import Aligner, BasicWordTiming, WordToken, tokens_to_word_tokens
from .refinement import Refiner
from .transcribe import transcribe_any

__all__ = ['Aligner', 'Refiner', 'transcribe_any', 'BasicWordTiming',
           'WordToken', 'tokens_to_word_tokens']
