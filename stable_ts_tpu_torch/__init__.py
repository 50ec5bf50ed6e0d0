"""stable_ts_tpu_torch: the PyTorch + CUDA port of stable_ts_tpu.

The ``transcribe`` path (log-mel -> encoder -> language detection ->
greedy, sampled (temperature ladder with best_of) or beam-search decoding
under the timestamp grammar -> cross-attention DTW word timing -> SRT) runs
in PyTorch on one NVIDIA Hopper GPU, with hand-written CUDA kernels where
the JAX package runs Pallas kernels on the TPU (flash attention, self- and
cross-attention decode with their beam and window-group entries, the
greedy logit epilogue, the DTW cost). The framework-free host code
(results, regrouping, silence suppression, text output, the tokenizer) is
shared with ``stable_ts_tpu``, which this package imports without
importing jax.
"""
from stable_ts_tpu._version import __version__
from stable_ts_tpu.result import WhisperResult, Segment, WordTiming
from stable_ts_tpu.text_output import (result_to_srt_vtt, result_to_ass,
                                       result_to_tsv, result_to_txt,
                                       save_as_json, load_result)

_LAZY = {
    'WhisperTorch': 'stable_ts_tpu_torch.loaders',
    'load_test_model': 'stable_ts_tpu_torch.loaders',
    'from_jax': 'stable_ts_tpu_torch.loaders',
    'transcribe_stable': 'stable_ts_tpu_torch.transcribe',
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
