"""Denoiser plugin registry + built-in spectral-gating denoiser.

Counterpart of the reference's denoiser registry
(audio/__init__.py:19-23 with demucs/dfnet/noisereduce backends). Those are
external torch/rust packages; here the built-in is a self-contained
noisereduce-style spectral gate (STFT -> per-band noise floor -> soft mask),
and any external denoiser plugs in by registering load/run callables.
"""
from typing import Callable, Dict, Optional

import numpy as np

from ..constants import SAMPLE_RATE
from ..defaults import cached_model_instances


def spectral_gate(
        audio: np.ndarray,
        sr: int = SAMPLE_RATE,
        n_fft: int = 1024,
        hop_length: int = 256,
        n_std_thresh: float = 1.5,
        noise_quantile: float = 0.1,
        prop_decrease: float = 1.0,
        freq_smooth_bins: int = 3,
        time_smooth_frames: int = 5,
        **_unused,
) -> np.ndarray:
    """Stationary spectral gating (noisereduce-style).

    The noise floor per frequency band is estimated from the quietest
    ``noise_quantile`` of frames; bins below floor + n_std * std are
    attenuated by ``prop_decrease`` with a smoothed soft mask.
    """
    from scipy.signal import stft, istft
    audio = np.asarray(audio, np.float32)
    if audio.size < n_fft:
        return audio
    _, _, spec = stft(audio, fs=sr, nperseg=n_fft, noverlap=n_fft - hop_length,
                      padded=True)
    mag = np.abs(spec)
    log_mag = np.log10(mag + 1e-10)

    frame_energy = log_mag.mean(axis=0)
    quiet_cut = np.quantile(frame_energy, noise_quantile)
    quiet = log_mag[:, frame_energy <= quiet_cut]
    if quiet.shape[1] < 2:
        quiet = log_mag
    noise_mean = quiet.mean(axis=1, keepdims=True)
    noise_std = quiet.std(axis=1, keepdims=True)
    threshold = noise_mean + n_std_thresh * noise_std

    mask = (log_mag > threshold).astype(np.float32)
    # Smooth the mask over frequency and time (separable box filters).
    if freq_smooth_bins > 1:
        kernel = np.ones(freq_smooth_bins) / freq_smooth_bins
        mask = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode='same'), 0, mask)
    if time_smooth_frames > 1:
        kernel = np.ones(time_smooth_frames) / time_smooth_frames
        mask = np.apply_along_axis(
            lambda m: np.convolve(m, kernel, mode='same'), 1, mask)
    gain = 1.0 - prop_decrease * (1.0 - mask)
    _, out = istft(spec * gain, fs=sr, nperseg=n_fft,
                   noverlap=n_fft - hop_length)
    out = out[:audio.size].astype(np.float32)
    if out.size < audio.size:
        out = np.pad(out, (0, audio.size - out.size))
    return out


def _load_demucs(**kw):
    """Vocals-isolation via Demucs (optional external plugin, torch).

    Counterpart of the reference's demucs wrapper (audio/demucs.py:20-31);
    raises with guidance when the package is absent.
    """
    try:
        from demucs.pretrained import get_model
    except ImportError as exc:
        raise ModuleNotFoundError(
            "denoiser 'demucs' needs the demucs package (pip install demucs); "
            "the built-in 'spectral_gate' denoiser has no dependencies") from exc
    model = get_model(kw.pop('model_name', 'htdemucs'))
    model.eval()
    return model


def _apply_demucs_chunked(model, wav, *, shifts: int = 0,
                          overlap: float = 0.25,
                          transition_power: float = 1.0,
                          segment: Optional[float] = None,
                          device=None, seed: Optional[int] = None,
                          progress: bool = False, num_workers: int = 0,
                          pool=None):
    """Chunked overlap-weighted source separation.

    Behavioral counterpart of the reference's own apply
    (audio/demucs.py:75-145): fixed-length segments at stride
    ``(1 - overlap) * segment``, triangular per-sample weights raised to
    ``transition_power``, normalized by the summed weight, with optional
    averaging over ``shifts`` random sub-segment shifts. Only one segment
    is ever resident, so arbitrarily long audio runs in bounded memory —
    delegating whole-signal processing to the model would OOM on long
    inputs.

    wav: torch (channels, T) at ``model.samplerate``.
    Returns torch (n_sources, channels, T).
    """
    import random
    import torch
    # progress/num_workers/pool are accepted for surface parity with the
    # reference's apply (audio/demucs.py:75) — this serial bounded-memory
    # apply has nothing to parallelize, and progress is the caller's
    # verbose-print concern; they are deliberately inert here.
    del num_workers, pool
    device = torch.device(device or 'cpu')
    model = model.to(device)
    channels, length = wav.shape
    seg_dur = segment if segment is not None else getattr(model, 'segment', 10.)
    seg = max(1, int(model.samplerate * float(seg_dur)))

    def infer(chunk):
        n = chunk.shape[-1]
        valid = (model.valid_length(n) if hasattr(model, 'valid_length')
                 else max(n, seg))
        delta = valid - n  # CENTERED padding + center trim, like the
        padded = torch.nn.functional.pad(  # reference's TensorChunk.padded
            chunk, (delta // 2, delta - delta // 2))
        with torch.no_grad():
            out = model(padded[None].to(device))[0].cpu()
        excess = out.shape[-1] - n
        return out[..., excess // 2:excess // 2 + n] if excess > 0 else out

    def split_apply(mix):
        total = mix.shape[-1]
        out = torch.zeros(len(model.sources), channels, total)
        sum_w = torch.zeros(total)
        stride = max(1, int((1 - overlap) * seg))
        weight = torch.cat([torch.arange(1, seg // 2 + 1),
                            torch.arange(seg - seg // 2, 0, -1)]).float()
        weight = (weight / weight.max()) ** transition_power
        for offset in range(0, total, stride):
            chunk = mix[:, offset:offset + seg]
            o = infer(chunk)
            n = o.shape[-1]
            out[..., offset:offset + n] += weight[:n] * o
            sum_w[offset:offset + n] += weight[:n]
        assert float(sum_w.min()) > 0
        return out / sum_w

    if not shifts:
        return split_apply(wav)
    # averaged random shifts de-phase the chunk grid (reference :135-143)
    rng = random.Random(seed)
    max_shift = int(0.5 * model.samplerate)
    padded = torch.nn.functional.pad(wav, (max_shift, max_shift))
    acc = torch.zeros(len(model.sources), channels, length)
    for _ in range(shifts):
        off = rng.randint(0, max_shift)
        shifted = padded[:, off:off + length + max_shift]
        lo = max_shift - off
        acc += split_apply(shifted)[..., lo:lo + length]
    return acc / shifts


def _run_demucs(audio: np.ndarray, model=None, device=None, **kw):
    import torch
    # demucs expects (channels, T) at its own sample rate; stable-ts feeds
    # 16 kHz mono, so resample the 1-D signal in and out
    # (reference audio/demucs.py:153-211). resample operates on 1-D arrays —
    # build the channel dim only after resampling.
    from .utils import resample
    in_sr = kw.pop('sr', SAMPLE_RATE)
    mono = np.asarray(audio, np.float32).reshape(-1)
    mono = np.asarray(resample(mono, in_sr, model.samplerate), np.float32)
    wav = torch.as_tensor(mono)[None].repeat(model.audio_channels, 1)
    if kw.pop('split', True):
        stems = _apply_demucs_chunked(model, wav, device=device, **kw)
    else:
        model = model.to(device or 'cpu')  # whole-signal path: model must
        with torch.no_grad():              # follow the input's device
            stems = model(wav[None].to(device or 'cpu'))[0].cpu()
    vocals = stems[model.sources.index('vocals')].mean(0).numpy()
    out = resample(vocals.reshape(-1), model.samplerate, in_sr)
    return np.asarray(out, np.float32)


def _load_dfnet(**kw):
    """DeepFilterNet enhancement (optional external plugin)."""
    try:
        from df import init_df
    except ImportError as exc:
        raise ModuleNotFoundError(
            "denoiser 'dfnet' needs the deepfilternet package; the built-in "
            "'spectral_gate' denoiser has no dependencies") from exc
    model, df_state, _ = init_df()
    return (model, df_state)


def _run_dfnet(audio: np.ndarray, model=None, **kw):
    import torch
    from df import enhance
    net, df_state = model
    from .utils import resample
    in_sr = kw.pop('sr', SAMPLE_RATE)
    mono = np.asarray(audio, np.float32).reshape(-1)
    wav = np.asarray(resample(mono, in_sr, df_state.sr()), np.float32)
    out = enhance(net, df_state, torch.as_tensor(wav)[None], **kw)[0].numpy()
    out = resample(out.reshape(-1), df_state.sr(), in_sr)
    return np.asarray(out, np.float32)


# Registry: name -> {'load': () -> model_or_None, 'run': (audio, model=..., **opts) -> audio}
SUPPORTED_DENOISERS: Dict[str, Dict[str, Callable]] = {
    'spectral_gate': {
        'load': lambda **kw: None,  # stateless
        'run': lambda audio, model=None, **kw: spectral_gate(audio, **kw),
    },
    # alias matching the reference's default plugin naming
    'noisereduce': {
        'load': lambda **kw: None,
        'run': lambda audio, model=None, **kw: spectral_gate(audio, **kw),
    },
    # optional external plugins (gated imports, reference audio/demucs.py
    # and audio/dfnet.py)
    'demucs': {'load': _load_demucs, 'run': _run_demucs},
    'dfnet': {'load': _load_dfnet, 'run': _run_dfnet},
}


def convert_demucs_kwargs(denoiser: Optional[str] = None,
                          denoiser_options: Optional[dict] = None,
                          demucs=None, demucs_options: Optional[dict] = None):
    """Map the deprecated ``demucs``/``demucs_options`` kwargs onto
    ``denoiser``/``denoiser_options`` (reference audio/__init__.py:42-71).

    ``demucs`` may also be a preloaded model object, which is forwarded as
    ``denoiser_options['model']``.
    """
    import warnings
    if demucs:
        warnings.warn('``demucs`` is deprecated. Use ``denoiser="demucs"`` '
                      'instead.', stacklevel=2)
        if denoiser and denoiser != 'demucs':
            raise ValueError(f'Demucs is enabled but got "{denoiser}" for denoiser.')
        denoiser = 'demucs'
    denoiser_options = denoiser_options or {}
    if demucs_options:
        warnings.warn('``demucs_options`` is deprecated. Use '
                      '``denoiser_options`` instead.', stacklevel=2)
        if denoiser == 'demucs':
            denoiser_options = demucs_options
            if demucs is not None and not isinstance(demucs, (bool, str)):
                denoiser_options['model'] = demucs  # preloaded model object
    return denoiser, denoiser_options


def register_denoiser(name: str, run: Callable, load: Optional[Callable] = None):
    """Register an external denoiser (e.g. a demucs wrapper)."""
    SUPPORTED_DENOISERS[name] = {
        'load': load or (lambda **kw: None),
        'run': run,
    }


def apply_denoiser(name: str, audio: np.ndarray, **options) -> np.ndarray:
    if name not in SUPPORTED_DENOISERS:
        raise NotImplementedError(
            f'unsupported denoiser: {name!r}; supported: '
            f'{tuple(SUPPORTED_DENOISERS)} (register more with '
            f'stable_ts_tpu_torch.audio.denoiser.register_denoiser)')
    entry = SUPPORTED_DENOISERS[name]
    cache = cached_model_instances.setdefault('denoisers', {})
    preloaded = options.pop('model', None)  # user-supplied instance wins
    if name not in cache:
        cache[name] = (preloaded if preloaded is not None
                       else entry['load'](**options.pop('load_options', {})))
    return entry['run'](audio, model=cache[name], **options)
