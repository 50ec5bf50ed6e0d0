"""Alternative inference backends plugged into the stabilization pipeline.

The PyTorch engine (models/whisper) is the fast path on the GPU; these
adapters let results from other engines flow through the same silence
suppression, word-timing alignment, refinement, and regroup machinery — the
reference keeps the same seam for faster-whisper / HF / MLX
(stable-ts stable_whisper/whisper_word_level/faster_whisper.py).
"""
from .faster_whisper import faster_transcribe, load_faster_whisper

__all__ = ['faster_transcribe', 'load_faster_whisper']
