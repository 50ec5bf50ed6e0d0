"""The user-facing model wrapper of the port (counterpart of
stable_ts_tpu/loaders.py:WhisperTPU, the method surface ``transcribe``
uses).

A model lives on one explicit device. Asking for ``cuda`` on a machine
without a GPU raises; nothing moves to the CPU behind the caller's back.
Checkpoint loading waits for weights in the repository (ROADMAP.md);
:func:`load_test_model` and :func:`from_jax` build models from a seed or
from a JAX model's weights.
"""
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .models.whisper.decoding import (DecodingOptions, decode as _decode,
                                      detect_language as _detect_language)
from .models.whisper.dims import ModelDimensions, tiny_test_dims
from .models.whisper.model import (Whisper, encoder_apply, init_params,
                                   resolve_device)
from .models.whisper.tokenizer import (WhisperTokenizer, get_tokenizer,
                                       synthetic_byte_ranks)


class WhisperTorch:
    """A Whisper model on one device: the weights (``params``, a
    :class:`~.models.whisper.model.Whisper` module) plus the task methods."""

    def __init__(self, dims: ModelDimensions, params: Whisper, *, device,
                 name: str = 'custom', vocab_path: Optional[str] = None,
                 ranks: Optional[dict] = None,
                 alignment_heads: Optional[Sequence[Tuple[int, int]]] = None):
        self.device = resolve_device(device)
        self.dims = dims
        self.params = params.to(self.device).requires_grad_(False).eval()
        self.name = name
        self.alignment_heads = alignment_heads
        self._vocab_path = vocab_path
        self._ranks = ranks
        self._tokenizers = {}

    @property
    def is_multilingual(self) -> bool:
        return self.dims.is_multilingual

    @property
    def num_languages(self) -> int:
        if self.dims.n_vocab >= 51865:
            return self.dims.num_languages
        return 99  # synthetic / test vocabularies

    def __repr__(self):
        return (f'WhisperTorch(name={self.name!r}, device={self.device}, '
                f'n_vocab={self.dims.n_vocab}, '
                f'layers={self.dims.n_audio_layer}+{self.dims.n_text_layer}, '
                f'width={self.dims.n_audio_state})')

    def get_tokenizer(self, language: Optional[str] = None,
                      task: Optional[str] = None) -> WhisperTokenizer:
        key = (language, task)
        if key not in self._tokenizers:
            if self._ranks is not None:
                tok = WhisperTokenizer(
                    self._ranks, multilingual=self.is_multilingual,
                    num_languages=self.num_languages, language=language,
                    task=task)
            else:
                tok = get_tokenizer(
                    multilingual=self.is_multilingual,
                    num_languages=self.num_languages, language=language,
                    task=task, vocab_path=self._vocab_path)
            if tok.n_vocab > self.dims.n_vocab:
                raise ValueError(
                    f'tokenizer vocab ({tok.n_vocab}) exceeds model vocab '
                    f'({self.dims.n_vocab}); wrong vocabulary file?')
            self._tokenizers[key] = tok
        return self._tokenizers[key]

    def _on_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x).to(self.device)

    @torch.inference_mode()
    def embed_audio(self, mel) -> torch.Tensor:
        """mel (n_mels, 3000) or (B, n_mels, 3000) -> features (B, 1500, d)."""
        mel = self._on_device(mel)
        if mel.ndim == 2:
            mel = mel[None]
        return encoder_apply(self.params.encoder, mel)

    def decode(self, mel_or_features, options: Optional[DecodingOptions] = None,
               ts_silence_mask=None, language: Optional[str] = None,
               with_features: bool = True,
               generator: Optional[torch.Generator] = None, **kwargs):
        """Decode windows (mels or encoder features) with ``options`` or the
        DecodingOptions ``kwargs``. A multilingual model with no language
        detects it from the first window. ``generator`` draws the samples
        at temperature > 0 (None: a fresh one seeded with 0)."""
        if options is None:
            options = DecodingOptions(**kwargs)
        language = options.language or language
        x = self._on_device(mel_or_features)
        if language is None:
            language = self.detect_language(x)[0][0] if self.is_multilingual else 'en'
        tokenizer = self.get_tokenizer(language=language, task=options.task)
        return _decode(self.params, self.dims, tokenizer, x, options,
                       ts_silence_mask=ts_silence_mask,
                       with_features=with_features, generator=generator)

    def detect_language(self, mel):
        """(language codes, probability maps) per window of ``mel`` (a mel
        or encoder features)."""
        tokenizer = self.get_tokenizer(language=None, task=None)
        return _detect_language(self.params, self.dims, tokenizer,
                                self._on_device(mel))

    def transcribe(self, audio, **kwargs):
        from .transcribe import transcribe_stable
        return transcribe_stable(self, audio, **kwargs)


def load_test_model(seed: int = 0, device='cpu', **kwargs) -> WhisperTorch:
    """A miniature random-weight model (tiny_test_dims, drawn from a torch
    Generator) wired to the synthetic byte tokenizer."""
    dims = tiny_test_dims()
    device = resolve_device(device)
    return WhisperTorch(dims, init_params(dims, seed=seed, device=device),
                        device=device, name='test-tiny',
                        ranks=synthetic_byte_ranks(), **kwargs)


def from_jax(model_tpu, device='cpu') -> WhisperTorch:
    """The port's model with the weights, dims, tokenizer source and
    alignment heads of a ``stable_ts_tpu`` WhisperTPU (its parameters are
    downloaded to numpy). Quantized (dq) models are not ported yet."""
    from .models.whisper.convert import from_jax_params
    if getattr(model_tpu, 'quantized', False):
        raise NotImplementedError('int8 weight-only (dq) models are still to '
                                  'be ported (ROADMAP.md)')
    dims = ModelDimensions(**vars(model_tpu.dims))
    device = resolve_device(device)
    return WhisperTorch(
        dims, from_jax_params(model_tpu.params, dims, device=device),
        device=device, name=model_tpu.name, vocab_path=model_tpu._vocab_path,
        ranks=model_tpu._ranks, alignment_heads=model_tpu.alignment_heads)
