"""stable_ts_tpu_torch: the PyTorch + CUDA port of stable_ts_tpu.

``load_model`` reads Whisper checkpoints (OpenAI ``.pt``, HF and MLX
directories) onto one NVIDIA Hopper GPU, or the CPU when asked. The
``transcribe`` path (log-mel -> encoder -> language detection -> greedy,
sampled (temperature ladder with best_of) or beam-search decoding under
the timestamp grammar -> cross-attention DTW word timing, with the legacy
or the 'new' aligner and optional extra models -> SRT), its
``transcribe_minimal`` variant, the batched driver
``model.transcribe_batched`` (30-s windows in groups, each group encoded
once and decoded as one batch, its word timing scored on the device and
queued on a second CUDA stream; ``batched.py``) and the train step
(teacher-forced cross-entropy, AdamW) run in PyTorch, with hand-written
CUDA kernels where
the JAX package runs Pallas kernels on the TPU (flash attention and its
backward, self- and cross-attention decode with their beam and
window-group entries, the greedy logit epilogue, the DTW cost, the int8
weight-only matmul of ``dq`` models, the streamed vocab projection).
``STABLE_TS_TPU_PROFILE`` traces a request with ``torch.profiler``, and
``profiling.recording()`` keeps the program's own spans and counters in
memory (``profiling.py``). ``model.shard()`` spreads a model over several GPUs,
one process each (``parallel/``: a (dp, tp) mesh with Megatron tensor
parallelism over tp and the batches' rows over dp). The ``stable-ts-tpu-torch`` command (``cli.py``, or
``python -m stable_ts_tpu_torch``) drives all of it from the shell, and a
faster-whisper model plugs into the same stabilization, alignment and
refinement (``backends/``). The framework-free host code (audio loading,
results, regrouping, silence suppression, text output, the tokenizer) is
the port's own copy of ``stable_ts_tpu``'s: this package imports nothing
of ``stable_ts_tpu`` and nothing of jax.
"""
from ._version import __version__
from .utils import tune_host_allocator as _tune_host_allocator

# Large-buffer allocator hygiene before any pipeline allocation happens
# (see utils.tune_host_allocator: multi-second page-fault overhead
# otherwise on hosts with slow memory fault-in).
_tune_host_allocator()
from .result import WhisperResult, Segment, WordTiming
from .text_output import (result_to_srt_vtt, result_to_ass, result_to_tsv,
                          result_to_txt, save_as_json, load_result)

_LAZY = {
    'load_model': 'stable_ts_tpu_torch.loaders',
    'load_hf_whisper': 'stable_ts_tpu_torch.loaders',
    'load_mlx_whisper': 'stable_ts_tpu_torch.loaders',
    'load_faster_whisper': 'stable_ts_tpu_torch.loaders',
    'modify_model': 'stable_ts_tpu_torch.loaders',
    'NonSpeechPredictor': 'stable_ts_tpu_torch.stabilization',
    'visualize_suppression': 'stable_ts_tpu_torch.stabilization',
    'encode_video_comparison': 'stable_ts_tpu_torch.video_output',
    'IS_WHISPERLESS_VERSION': 'stable_ts_tpu_torch.constants',
    'WhisperTorch': 'stable_ts_tpu_torch.loaders',
    'load_test_model': 'stable_ts_tpu_torch.loaders',
    'from_jax': 'stable_ts_tpu_torch.loaders',
    'align': 'stable_ts_tpu_torch.alignment',
    'align_words': 'stable_ts_tpu_torch.alignment',
    'refine': 'stable_ts_tpu_torch.alignment',
    'locate': 'stable_ts_tpu_torch.alignment',
    'AllOptions': 'stable_ts_tpu_torch.options',
    'transcribe_any': 'stable_ts_tpu_torch.non_whisper',
    'Aligner': 'stable_ts_tpu_torch.non_whisper.alignment',
    'Refiner': 'stable_ts_tpu_torch.non_whisper.refinement',
    'transcribe_stable': 'stable_ts_tpu_torch.transcribe',
    'transcribe_minimal': 'stable_ts_tpu_torch.transcribe',
    'make_train_step': 'stable_ts_tpu_torch.models.whisper.train',
    'cross_entropy_loss': 'stable_ts_tpu_torch.models.whisper.train',
    'launch_counts': 'stable_ts_tpu_torch._build',
    'reset_launch_counts': 'stable_ts_tpu_torch._build',
}

__all__ = ['WhisperResult', 'Segment', 'WordTiming', 'result_to_srt_vtt',
           'result_to_ass', 'result_to_tsv', 'result_to_txt', 'save_as_json',
           'load_result', '__version__', *_LAZY]


def __getattr__(name):
    # torch and the model code load lazily, like stable_ts_tpu's exports.
    if name in _LAZY:
        import importlib
        module = importlib.import_module(_LAZY[name])
        return getattr(module, name)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
