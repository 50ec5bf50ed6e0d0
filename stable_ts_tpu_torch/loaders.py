"""Model loading and the user-facing model wrapper of the port
(counterpart of stable_ts_tpu/loaders.py: ``WhisperTPU``, ``load_model``,
``modify_model``).

A model lives on one explicit device, the GPU unless the caller asks for
``device='cpu'``. Asking for ``cuda`` on a machine without a GPU raises;
nothing moves to the CPU behind the caller's back.
:func:`load_model` reads an OpenAI ``.pt`` file, an HF directory or an
MLX directory (``models/whisper/load.py``), by path or by name;
:func:`load_test_model` and :func:`from_jax` build models from a seed or
from a JAX model's weights. ``dq=True`` quantizes the q/k/v/out/fc1/fc2
linears to int8 weights with per-output-channel scales on the model's
device (stable_ts_tpu/loaders.py:41-47). :meth:`WhisperTorch.shard` puts a
model on a (dp, tp) mesh of ``torch.distributed`` ranks, one process per
GPU (``parallel/``).
"""
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from . import profiling
# load_faster_whisper is exported from here, as in stable_ts_tpu.loaders
from .backends.faster_whisper import (is_faster_whisper_model, load_faster_whisper,
                                      modify_fw_model)
from .models.whisper.decoding import (DecodingOptions,
                                      decode_collect as _decode_collect,
                                      decode_launch as _decode_launch,
                                      detect_language as _detect_language)
from .models.whisper.dims import (OPENAI_MODEL_DIMS, ModelDimensions,
                                   tiny_test_dims)
from .models.whisper.model import (Whisper, encoder_apply, init_params,
                                   resolve_device)
from .models.whisper.quantization import is_quantized, quantize_params
from .models.whisper.tokenizer import (WhisperTokenizer, get_tokenizer,
                                       synthetic_byte_ranks)

_VOCAB_CANDIDATES = ('multilingual.tiktoken', 'gpt2.tiktoken', 'vocab.json')


class WhisperTorch:
    """A Whisper model on one device: the weights (``params``, a
    :class:`~.models.whisper.model.Whisper` module) plus the task methods.
    ``dq=True`` swaps the linears of ``params`` for int8 weight-only ones,
    in place, after moving them to the device."""

    def __init__(self, dims: ModelDimensions, params: Whisper, *, device,
                 name: str = 'custom', vocab_path: Optional[str] = None,
                 ranks: Optional[dict] = None,
                 alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
                 dq: bool = False):
        self.device = resolve_device(device)
        self.dims = dims
        self.params = params.to(self.device).requires_grad_(False).eval()
        if dq:
            quantize_params(self.params)
        self.quantized = is_quantized(self.params)
        self.name = name
        self.alignment_heads = alignment_heads
        self.mesh = None
        self._vocab_path = vocab_path
        self._ranks = ranks
        self._tokenizers = {}

    # -- device mesh ---------------------------------------------------------------------

    def shard(self, mesh=None, tp: Optional[int] = None) -> 'WhisperTorch':
        """Put the model on a (dp, tp) mesh of the ``torch.distributed``
        world (``parallel.build_mesh(tp=tp)`` unless a mesh is given; a
        process outside any world starts a world of one). This rank keeps
        its Megatron column / row shard of the weights over ``tp``
        (``parallel.shard_params``), and the batch entries split their rows
        over ``dp``: :meth:`embed_audio` and :meth:`decode_launch` inside,
        the timing, align and refine passes through :meth:`shard_batch`
        (stable_ts_tpu/loaders.py:59-78). Every rank calls the same methods
        with the same arguments. Returns self."""
        from .parallel.mesh import build_mesh, shard_params
        if mesh is None:
            mesh = build_mesh(tp=tp, devices=self.device.type)
        shard_params(self.params, mesh, self.dims)
        self.mesh = mesh
        return self

    def shard_batch(self, arr):
        """(this rank's rows of ``arr`` on the model's device, the real row
        count): the rows padded to a dp multiple by repeating the last one,
        then split evenly over dp (stable_ts_tpu/loaders.py:80-97). Without
        a mesh: ``arr`` on the device and its length."""
        from .parallel.mesh import split_batch
        return split_batch(arr, self.mesh, self.device)

    def gather_batch(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """All-gather a result of :meth:`shard_batch`'s rows over dp along
        ``dim``: the padded global batch, on every rank. The identity
        without a mesh."""
        from .parallel.mesh import gather_batch
        return gather_batch(t, self.mesh, dim)

    def _dp_split(self) -> bool:
        return self.mesh is not None and self.mesh['dp'].size() > 1

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
        """mel (n_mels, 3000) or (B, n_mels, 3000) -> features (B, 1500, d).
        On a dp mesh each rank encodes its rows and the features are
        gathered: every rank returns all B. With the recorder on, a span
        ``encoder`` whose device time, on the card, goes to counter
        ``encoder.device_ms`` (``profiling.py``)."""
        if mel.ndim == 2:
            mel = mel[None]
        with profiling.span('encoder', device_time=self.device.type == 'cuda'):
            if not self._dp_split():
                return encoder_apply(self.params.encoder, self._on_device(mel))
            mel_in, n = self.shard_batch(mel)
            return self.gather_batch(encoder_apply(self.params.encoder, mel_in))[:n]

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
        return self.decode_collect(
            self.decode_launch(x, options, ts_silence_mask=ts_silence_mask,
                               language=language, generator=generator),
            with_features=with_features)

    def decode_launch(self, mel_or_features,
                      options: Optional[DecodingOptions] = None,
                      ts_silence_mask=None, language: Optional[str] = None,
                      generator: Optional[torch.Generator] = None, **kwargs):
        """Run a batched decode and keep its outputs on the device (a
        :class:`~.models.whisper.decoding.PendingDecode`); pair with
        :meth:`decode_collect`. Pass encoder features to reuse them across
        the fallback rungs. With no language it decodes as 'en', as JAX's
        ``decode_launch`` does (loaders.py:187-190): callers detect first."""
        if options is None:
            options = DecodingOptions(**kwargs)
        tokenizer = self.get_tokenizer(
            language=options.language or language or 'en', task=options.task)
        if self.mesh is None:
            return _decode_launch(self.params, self.dims, tokenizer,
                                  self._on_device(mel_or_features), options,
                                  ts_silence_mask=ts_silence_mask,
                                  generator=generator)
        # on a mesh: every rank decodes its rows of the global features
        # (the outputs are gathered in decode_collect), and an
        # out-of-memory error on any rank raises on every rank, so that
        # all of them retry together: a rank retrying alone would leave the
        # others waiting in a collective. The agreement comes after the
        # decode, and at tp > 1 the decode runs tp all-reduces: it holds
        # when every rank of a tp group raises (they allocate the same
        # shapes in the same order), but a rank that raises alone leaves
        # the rest of its tp group in their next all-reduce until the
        # backend's timeout (ROADMAP.md section 3).
        from .parallel.mesh import all_ranks_agree, batch_rows, split_batch
        x = mel_or_features
        if x.ndim == 2:
            x = x[None]
        feats = (self.embed_audio(x) if x.shape[-2] == self.dims.n_mels
                 else self._on_device(x))
        feats_in, n = self.shard_batch(feats)
        mask = ts_silence_mask
        if mask is not None:
            mask = np.asarray(mask, bool)
            if mask.ndim == 1:
                mask = np.repeat(mask[None], n, axis=0)
            mask = split_batch(mask, self.mesh, 'cpu')[0].numpy()
        try:
            pending = _decode_launch(self.params, self.dims, tokenizer, feats_in,
                                     options, ts_silence_mask=mask,
                                     generator=generator,
                                     batch_slice=(batch_rows(n, self.mesh)[1], n))
        except torch.OutOfMemoryError:
            pending = None
        if all_ranks_agree(pending is None, self.device, self.mesh):
            raise torch.OutOfMemoryError('device out of memory on a rank of the mesh')
        pending.xa, pending.gather, pending.n_windows = (
            feats, self.gather_batch, n)
        return pending

    def decode_collect(self, pending, with_features: bool = True):
        """Download a launched decode's outputs; its DecodingResults."""
        return _decode_collect(pending, with_features=with_features)

    def detect_language(self, mel):
        """(language codes, probability maps) per window of ``mel`` (a mel
        or encoder features)."""
        tokenizer = self.get_tokenizer(language=None, task=None)
        return _detect_language(self.params, self.dims, tokenizer,
                                self._on_device(mel))

    def transcribe(self, audio, **kwargs):
        from .transcribe import transcribe_stable
        return transcribe_stable(self, audio, **kwargs)

    def transcribe_minimal(self, audio, **kwargs):
        from .transcribe import transcribe_minimal
        return transcribe_minimal(self, audio, **kwargs)

    def transcribe_batched(self, audio, **kwargs):
        from .batched import transcribe_batched
        return transcribe_batched(self, audio, **kwargs)

    def align(self, audio, text, **kwargs):
        from .alignment import align
        return align(self, audio, text, **kwargs)

    def align_words(self, audio, result, **kwargs):
        from .alignment import align_words
        return align_words(self, audio, result, **kwargs)

    def refine(self, audio, result, **kwargs):
        from .alignment import refine
        return refine(self, audio, result, **kwargs)

    def locate(self, audio, text, **kwargs):
        from .alignment import locate
        return locate(self, audio, text, **kwargs)


def load_test_model(seed: int = 0, device='cuda', **kwargs) -> WhisperTorch:
    """A miniature random-weight model (tiny_test_dims, drawn from a torch
    Generator) wired to the synthetic byte tokenizer; ``kwargs`` go to
    :class:`WhisperTorch` (``dq=True``, ``alignment_heads``)."""
    dims = tiny_test_dims()
    device = resolve_device(device)
    return WhisperTorch(dims, init_params(dims, seed=seed, device=device),
                        device=device, name='test-tiny',
                        ranks=synthetic_byte_ranks(), **kwargs)


def from_jax(model_tpu, device='cuda') -> WhisperTorch:
    """The port's model with the weights, dims, tokenizer source and
    alignment heads of a ``stable_ts_tpu`` WhisperTPU (its parameters are
    downloaded to numpy). A ``dq`` model's int8 weights and scales carry
    over exactly."""
    from .models.whisper.convert import from_jax_params
    dims = ModelDimensions(**vars(model_tpu.dims))
    device = resolve_device(device)
    return WhisperTorch(
        dims, from_jax_params(model_tpu.params, dims, device=device),
        device=device, name=model_tpu.name, vocab_path=model_tpu._vocab_path,
        ranks=model_tpu._ranks, alignment_heads=model_tpu.alignment_heads)


def _find_vocab(checkpoint_path: str) -> Optional[str]:
    """A vocabulary file in $STABLE_TS_TPU_VOCAB_DIR, beside the checkpoint
    (inside it, for a directory), or in the directory above: the JAX
    package hands its search the checkpoint's directory and so looks only
    there (loaders.py:295)."""
    path = os.path.abspath(checkpoint_path)
    here = path if os.path.isdir(path) else os.path.dirname(path)
    search_dirs = [here, os.path.dirname(here)]
    if os.environ.get('STABLE_TS_TPU_VOCAB_DIR'):
        search_dirs.insert(0, os.environ['STABLE_TS_TPU_VOCAB_DIR'])
    for d in search_dirs:
        for name in _VOCAB_CANDIDATES:
            p = os.path.join(d, name)
            if os.path.isfile(p):
                return p
    return None


def load_model(name_or_path: str, *, vocab_path: Optional[str] = None,
               dtype=None,
               alignment_heads: Optional[Sequence[Tuple[int, int]]] = None,
               download_root: Optional[str] = None, dq: bool = False,
               device='cuda', **_ignored) -> WhisperTorch:
    """Load a Whisper model onto ``device`` from an OpenAI .pt file, an HF
    directory, an MLX directory, or a model name resolved inside
    ``download_root`` / $STABLE_TS_TPU_MODELS / ~/.cache/whisper.

    ``dtype=None`` gives f32 weights, ``torch.bfloat16`` bf16. A model name
    the alignment-head table knows (from the name or the file name) gets
    its canonical heads; any other keeps None and selects heads
    dynamically. The vocabulary comes from ``vocab_path``, or a
    ``multilingual.tiktoken`` / ``gpt2.tiktoken`` / ``vocab.json`` in
    $STABLE_TS_TPU_VOCAB_DIR or beside the checkpoint."""
    from .models.whisper.load import (is_mlx_checkpoint_dir, load_hf_checkpoint,
                                      load_mlx_checkpoint, load_openai_checkpoint)
    device = resolve_device(device)
    path = name_or_path
    if not os.path.exists(path):
        roots = [download_root, os.environ.get('STABLE_TS_TPU_MODELS'),
                 os.path.expanduser('~/.cache/whisper')]
        for root in filter(None, roots):
            candidate = os.path.join(root, f'{name_or_path}.pt')
            if os.path.isfile(candidate):
                path = candidate
                break
        else:
            known = ', '.join(sorted(OPENAI_MODEL_DIMS))
            raise FileNotFoundError(
                f'checkpoint not found for {name_or_path!r}. Provide a path to '
                f'an OpenAI .pt file or an HF or MLX model directory. Known '
                f'model names (searched in download_root / '
                f'$STABLE_TS_TPU_MODELS / ~/.cache/whisper): {known}')
    if os.path.isdir(path):
        loader = (load_mlx_checkpoint if is_mlx_checkpoint_dir(path)
                  else load_hf_checkpoint)
    else:
        loader = load_openai_checkpoint
    dims, params = loader(path, dtype=dtype, device=device)
    if alignment_heads is None:
        # canonical per-model heads; checkpoints the table does not know
        # keep None and select heads dynamically (timing.py)
        from .models.whisper.alignment_heads import (get_alignment_heads,
                                                     resolve_model_name)
        known = resolve_model_name(name_or_path) or resolve_model_name(path)
        if known:
            alignment_heads = get_alignment_heads(
                known, dims.n_text_layer, dims.n_text_head)
    if vocab_path is None:
        vocab_path = _find_vocab(path)
    if vocab_path is None and dims.n_vocab >= 51864:
        raise FileNotFoundError(
            'no tokenizer vocabulary found: place multilingual.tiktoken / '
            'gpt2.tiktoken / vocab.json next to the checkpoint, set '
            '$STABLE_TS_TPU_VOCAB_DIR, or pass vocab_path=.')
    return WhisperTorch(dims, params, device=device, name=os.path.basename(path),
                        vocab_path=vocab_path, alignment_heads=alignment_heads,
                        dq=dq)


def load_hf_whisper(name_or_path: str, **kwargs) -> WhisperTorch:
    """Load an HF Whisper directory (alias with the reference's loader name)."""
    return load_model(name_or_path, **kwargs)


def load_mlx_whisper(name_or_path: str, **kwargs) -> WhisperTorch:
    """Load an MLX-community Whisper directory onto the port's engine (the
    reference runs these on Apple's MLX runtime; here the directory is one
    more weight format, ``models/whisper/load.py:load_mlx_checkpoint``)."""
    return load_model(name_or_path, **kwargs)


def modify_model(model):
    """Give ``model`` the stabilized method surface, in place (the
    reference's ``modify_model``, original_whisper.py:931). A
    :class:`WhisperTorch` carries every method already and passes through
    unchanged; a ``faster_whisper.WhisperModel`` gets the methods that
    ``load_faster_whisper`` attaches; anything else raises ``TypeError``."""
    if isinstance(model, WhisperTorch):
        return model
    if is_faster_whisper_model(model):
        return modify_fw_model(model)
    raise TypeError(
        f'cannot modify {type(model).__name__!r}: expected a WhisperTorch or a '
        'faster_whisper.WhisperModel. Other ASR engines plug in through '
        'transcribe_any / Aligner / Refiner.')
