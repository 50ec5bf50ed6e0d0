"""Whisper in PyTorch: model, decoding, word timing, and the host-side
tokenizer, language and alignment-head tables (the port's own copies of
stable_ts_tpu's framework-free modules)."""
from . import alignment_heads, languages, tokenizer
from .dims import OPENAI_MODEL_DIMS, ModelDimensions, tiny_test_dims

__all__ = ['languages', 'tokenizer', 'alignment_heads', 'OPENAI_MODEL_DIMS',
           'ModelDimensions', 'tiny_test_dims']
