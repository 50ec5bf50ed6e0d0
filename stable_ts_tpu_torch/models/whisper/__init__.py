"""Whisper in PyTorch: model, decoding, word timing.

The tokenizer, language and alignment-head tables are framework-free files
of stable_ts_tpu, but importing them through ``stable_ts_tpu.models.whisper``
runs that package's ``__init__`` (which imports the JAX model). They are
therefore loaded here by file path, under this package's names
(``stable_ts_tpu_torch.models.whisper.tokenizer`` etc.), so the tokenizer's
``from .languages import ...`` resolves inside this package and jax is
never imported.
"""
import importlib.util
import sys
from pathlib import Path

import stable_ts_tpu


def _load_shared(name: str):
    full = f'{__name__}.{name}'
    if full in sys.modules:
        return sys.modules[full]
    path = (Path(stable_ts_tpu.__file__).resolve().parent / 'models'
            / 'whisper' / f'{name}.py')
    spec = importlib.util.spec_from_file_location(full, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[full] = module
    spec.loader.exec_module(module)
    return module


languages = _load_shared('languages')
tokenizer = _load_shared('tokenizer')
alignment_heads = _load_shared('alignment_heads')

from .dims import OPENAI_MODEL_DIMS, ModelDimensions, tiny_test_dims  # noqa: E402

__all__ = ['languages', 'tokenizer', 'alignment_heads', 'OPENAI_MODEL_DIMS',
           'ModelDimensions', 'tiny_test_dims']
