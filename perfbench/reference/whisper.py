"""Whisper in plain PyTorch, f32, from OpenAI's state-dict layout.

- :func:`log_mel`: Whisper's front end (centered STFT of 400 samples, hop
  160, periodic Hann, power with the last frame dropped, the slaney mel
  filterbank built here from librosa's formula, log10 clamped at 1e-10,
  floored 8 below the peak, (x + 4) / 4), on one 30-s window.
- :class:`Reference`: the encoder and the teacher-forced decoder, built
  from a state dict. ``weight_format='fp8'`` and
  ``kv_bits=4`` make the control, the model computed in float8 e4m3 where
  the configuration computes in bfloat16: every linear, convolution and
  embedding weight rounded to e4m3 with a scale per output row, the input
  of every linear and convolution and of the logits' product rounded to
  e4m3 with a scale per position, and the decoder's keys and values
  rounded to int4 with a scale per position.

Matrix products run in f32 with TF32 off (the caller turns it off).
"""
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

SR = 16000
N_FFT = 400
HOP = 160
N_SAMPLES = 30 * SR


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    log = 15.0 + np.log(np.maximum(f, 1000.0) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    lin = m * (200.0 / 3)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, lin)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels, htk=False,
    norm='slaney'), (n_mels, 201) f64."""
    fft_f = np.linspace(0, SR / 2, N_FFT // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SR / 2),
                                   n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    weights = np.zeros((n_mels, len(fft_f)))
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        weights[i] = np.maximum(0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights


def log_mel(window: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, <= N_SAMPLES) f32 samples in [-1, 1], zero-padded here to one
    window -> (B, n_mels, 3000)."""
    x = F.pad(window.float(), (0, N_SAMPLES - window.shape[-1]))
    spec = torch.stft(x, N_FFT, HOP, window=torch.hann_window(N_FFT, device=x.device),
                      center=True, pad_mode='reflect', return_complex=True)
    power = spec[..., :-1].abs() ** 2
    filt = torch.from_numpy(mel_filters(n_mels)).float().to(x.device)
    mel = filt @ power
    logs = torch.clamp(mel, min=1e-10).log10()
    logs = torch.maximum(logs, logs.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return (logs + 4.0) / 4.0


def _fp8_rows(w: torch.Tensor) -> torch.Tensor:
    """w rounded to float8 e4m3 with a scale per output row (dim 0)."""
    flat = w.reshape(w.shape[0], -1)
    scale = flat.abs().amax(dim=1, keepdim=True).clamp(min=1e-30) / 448.0
    q = (flat / scale).to(torch.float8_e4m3fn).float()
    return (q * scale).reshape(w.shape)


def _fp8_positions(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """x rounded to float8 e4m3 with a scale per position: over ``dim``,
    the features (a convolution's input: its channels)."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _int4_rows(x: torch.Tensor) -> torch.Tensor:
    """x (..., d) rounded to int4 with a scale per row."""
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / 7.0
    return torch.clamp(torch.round(x / scale), -8, 7) * scale


class Reference:
    """Whisper from an OpenAI-layout state dict, f32 on ``device``."""

    def __init__(self, sd: Dict[str, torch.Tensor], dims: dict, device,
                 weight_format: Optional[str] = None,
                 kv_bits: Optional[int] = None):
        self.dims = dims
        self.kv_bits = kv_bits
        self.fp8 = weight_format == 'fp8'
        self.w = {}
        for name, t in sd.items():
            t = t.to(device=device, dtype=torch.float32)
            if weight_format == 'fp8' and t.ndim >= 2 and 'positional' not in name:
                t = _fp8_rows(t)
            self.w[name] = t

    # -- pieces --------------------------------------------------------------------------

    def _ln(self, x, prefix):
        return F.layer_norm(x, (x.shape[-1],), self.w[prefix + '.weight'],
                            self.w[prefix + '.bias'], 1e-5)

    def _in(self, x, dim=-1):
        """A matrix product's input, in the control's precision."""
        return _fp8_positions(x, dim) if self.fp8 else x

    def _lin(self, x, prefix):
        b = self.w.get(prefix + '.bias')
        return F.linear(self._in(x), self.w[prefix + '.weight'], b)

    def _attn(self, x, kv_src, prefix, n_head, mask=None, quant_kv=False):
        q = self._lin(x, prefix + '.query')
        k = self._lin(kv_src, prefix + '.key')
        v = self._lin(kv_src, prefix + '.value')
        if quant_kv and self.kv_bits == 4:
            k, v = _int4_rows(k), _int4_rows(v)
        b, t, d = q.shape
        s = k.shape[1]
        dh = d // n_head
        scale = dh ** -0.25
        qh = q.view(b, t, n_head, dh).transpose(1, 2) * scale
        kh = k.view(b, s, n_head, dh).transpose(1, 2) * scale
        vh = v.view(b, s, n_head, dh).transpose(1, 2)
        qk = qh @ kh.transpose(-1, -2)
        if mask is not None:
            qk = qk + mask
        out = (torch.softmax(qk, dim=-1) @ vh).transpose(1, 2).reshape(b, t, d)
        return self._lin(out, prefix + '.out')

    # -- the model ----------------------------------------------------------------------

    @torch.no_grad()
    def encode(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, 3000) -> (B, 1500, d)."""
        w = self.w
        x = F.gelu(F.conv1d(self._in(mel, 1), w['encoder.conv1.weight'],
                            w['encoder.conv1.bias'], padding=1))
        x = F.gelu(F.conv1d(self._in(x, 1), w['encoder.conv2.weight'],
                            w['encoder.conv2.bias'], stride=2, padding=1))
        x = x.transpose(1, 2) + w['encoder.positional_embedding']
        for i in range(self.dims['n_audio_layer']):
            p = f'encoder.blocks.{i}'
            h = self._ln(x, p + '.attn_ln')
            x = x + self._attn(h, h, p + '.attn', self.dims['n_audio_head'])
            h = self._ln(x, p + '.mlp_ln')
            x = x + self._lin(F.gelu(self._lin(h, p + '.mlp.0')), p + '.mlp.2')
        return self._ln(x, 'encoder.ln_post')

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor, xa: torch.Tensor) -> torch.Tensor:
        """Teacher-forced pass: tokens (B, T) -> logits (B, T, V) f32."""
        w = self.w
        t = tokens.shape[1]
        x = w['decoder.token_embedding.weight'][tokens] \
            + w['decoder.positional_embedding'][:t]
        mask = torch.full((t, t), -np.inf, device=x.device).triu(1)
        n_head = self.dims['n_text_head']
        for i in range(self.dims['n_text_layer']):
            p = f'decoder.blocks.{i}'
            h = self._ln(x, p + '.attn_ln')
            x = x + self._attn(h, h, p + '.attn', n_head, mask=mask, quant_kv=True)
            x = x + self._attn(self._ln(x, p + '.cross_attn_ln'), xa,
                               p + '.cross_attn', n_head, quant_kv=True)
            h = self._ln(x, p + '.mlp_ln')
            x = x + self._lin(F.gelu(self._lin(h, p + '.mlp.0')), p + '.mlp.2')
        x = self._ln(x, 'decoder.ln')
        return self._in(x) @ w['decoder.token_embedding.weight'].t()
