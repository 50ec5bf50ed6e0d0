"""Whisper audio/model constants.

These mirror the constants the reference obtains from openai-whisper (or its
whisperless fallback, stable-ts stable_whisper/whisper_compatibility.py:82-90).
They are structural to the Whisper architecture and identical for all model sizes.
"""
SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
# Samples in one 30-second window.
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000
# Mel-spectrogram frames in one window (before the encoder's conv stride-2).
N_FRAMES = N_SAMPLES // HOP_LENGTH  # 3000
# Encoder output positions per window (after stride-2 conv).
N_AUDIO_CTX = N_FRAMES // 2  # 1500
N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # 320
FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100
TOKENS_PER_SECOND = SAMPLE_RATE // N_SAMPLES_PER_TOKEN  # 50
# Decoder text context length.
N_TEXT_CTX = 448

# The reference exposes IS_WHISPERLESS_VERSION to signal it can run without
# openai-whisper installed (whisper_compatibility.py). This package never
# depends on openai-whisper at all, so the flag is constitutively True; it
# exists so migrating code that checks it keeps working.
IS_WHISPERLESS_VERSION = True
