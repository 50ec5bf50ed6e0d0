"""Whisper in PyTorch: model, decoding, word timing, the train step, and
the host-side tokenizer, language and alignment-head tables (the port's
own copies of stable_ts_tpu's framework-free modules)."""
from . import alignment_heads, languages, tokenizer
from .dims import OPENAI_MODEL_DIMS, ModelDimensions, tiny_test_dims

__all__ = ['languages', 'tokenizer', 'alignment_heads', 'OPENAI_MODEL_DIMS',
           'ModelDimensions', 'tiny_test_dims', 'make_train_step',
           'cross_entropy_loss']


def __getattr__(name):
    # the train step loads torch and the model code on first use
    if name in ('make_train_step', 'cross_entropy_loss'):
        from . import train
        return getattr(train, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
