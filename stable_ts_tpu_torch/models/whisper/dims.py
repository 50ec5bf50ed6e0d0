"""Model dimensions and the OpenAI model catalog, as plain data.

Restates stable_ts_tpu/models/whisper/model.py:ModelDimensions and
load.py:OPENAI_MODEL_DIMS, which live in modules that import jax; a CPU
test holds this table equal to the JAX package's.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def is_multilingual(self) -> bool:
        return self.n_vocab >= 51865

    @property
    def num_languages(self) -> int:
        return self.n_vocab - 51765 - int(self.is_multilingual)


def _dims(n_mels, width, heads, n_audio_layer, n_vocab, n_text_layer=None):
    return dict(n_mels=n_mels, n_audio_ctx=1500, n_audio_state=width,
                n_audio_head=heads, n_audio_layer=n_audio_layer,
                n_vocab=n_vocab, n_text_ctx=448, n_text_state=width,
                n_text_head=heads,
                n_text_layer=(n_audio_layer if n_text_layer is None
                              else n_text_layer))


OPENAI_MODEL_DIMS = {
    'tiny.en': _dims(80, 384, 6, 4, 51864),
    'tiny': _dims(80, 384, 6, 4, 51865),
    'base.en': _dims(80, 512, 8, 6, 51864),
    'base': _dims(80, 512, 8, 6, 51865),
    'small.en': _dims(80, 768, 12, 12, 51864),
    'small': _dims(80, 768, 12, 12, 51865),
    'medium.en': _dims(80, 1024, 16, 24, 51864),
    'medium': _dims(80, 1024, 16, 24, 51865),
    'large-v1': _dims(80, 1280, 20, 32, 51865),
    'large-v2': _dims(80, 1280, 20, 32, 51865),
    'large-v3': _dims(128, 1280, 20, 32, 51866),
    'large-v3-turbo': _dims(128, 1280, 20, 32, 51866, n_text_layer=4),
}
OPENAI_MODEL_DIMS['large'] = OPENAI_MODEL_DIMS['large-v3']
OPENAI_MODEL_DIMS['turbo'] = OPENAI_MODEL_DIMS['large-v3-turbo']


def tiny_test_dims(n_vocab: int = 1864) -> ModelDimensions:
    """The miniature config of the tests (1864 = 256 byte tokens + the
    synthetic tokenizer's 1608 specials); not a real checkpoint size."""
    return ModelDimensions(
        n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
        n_audio_layer=2, n_vocab=n_vocab, n_text_ctx=448, n_text_state=64,
        n_text_head=2, n_text_layer=2)
