"""The greedy decode step's epilogue (kernel E, ``csrc/logit_epilogue.cu``).

Replaces stable_ts_tpu/ops/logit_epilogue.py:_kernel
(``fused_logit_aggregates``). From the decoder's post-LN hidden state x
(B, d) and the tied embedding (V, d) it computes the logits x . emb^T (x
cast to the embedding's dtype, products summed in f32), adds the suppress
vector and the timestamp-silence mask, sets the timestamp-grammar bans to
-1e9, and returns six per-row aggregates

    [m_text, a_text, s_text, m_ts, a_ts, s_ts]  (B, 6) f32

(max, first argmax, sum of exp(f - max)) over the text ids [0, ts_begin)
and the timestamp ids [ts_begin, V). They are all the greedy loop needs:
:func:`select_from_aggregates` turns them into the next token and its
logprob, force-timestamp rule included. The kernel streams the embedding
once per step and never writes the (B, V) logits; see its source note.

Filter semantics (the loop's steps i >= 1; the i == 0 rules run once per
window through the unfused ``LogitFilter``): suppress and silence are
ADDED; ``flags`` (B, 4) int32 ``[text_ban, ts_ban, has_ts, ts_floor]`` SET
-1e9 on every timestamp (ts_ban), on ids < eot (text_ban) and on
timestamps below ts_begin + ts_floor (has_ts). An argmax keeps the first
(lowest) id among equal maxima.

:func:`logit_aggregates` (JAX's ``logit_aggregates_xla``) reduces already
filtered (B, V) logits; the decode loop uses it once per window on the
prefill logits, on either device, as JAX does.
"""
import torch

from .. import _build

_NEG = -1e9     # grammar ban value
_MINF = -1e30   # fold identity


def logit_aggregates(filtered: torch.Tensor, ts_begin: int) -> torch.Tensor:
    """(B, 6) aggregates of filtered f32 logits (B, V)."""
    ids = torch.arange(filtered.shape[-1], device=filtered.device)
    parts = []
    for mask in (ids < ts_begin, ids >= ts_begin):
        fm = torch.where(mask, filtered, _MINF)
        m = fm.amax(dim=-1)
        # first maximum: the smallest id holding it
        a = torch.where(fm == m[:, None], ids, 2 ** 30).amin(dim=-1)
        s = torch.exp(fm - m[:, None]).sum(dim=-1)
        parts += [m, a.float(), s]
    return torch.stack(parts, dim=-1)


def grammar_filter(logits, suppress, ts_silence, flags, ts_begin: int,
                   eot: int, with_grammar: bool = True) -> torch.Tensor:
    """The epilogue's filters on full (B, V) f32 logits."""
    f = logits + suppress
    if ts_silence is not None:
        f = f + ts_silence
    if not with_grammar:
        return f
    ids = torch.arange(f.shape[-1], device=f.device)
    is_ts = ids >= ts_begin
    text_ban, ts_ban, has_ts, floor = (flags[:, k:k + 1] for k in range(4))
    f = torch.where((ts_ban > 0) & is_ts, _NEG, f)
    f = torch.where((text_ban > 0) & (ids < eot), _NEG, f)
    return torch.where((has_ts > 0) & is_ts & (ids < ts_begin + floor), _NEG, f)


def fused_logit_aggregates_ref(x, emb, suppress, ts_silence, flags, ts_begin: int,
                               eot: int, with_grammar: bool = True) -> torch.Tensor:
    """Plain twin: the (B, V) logits, the filters, then the aggregates."""
    logits = x.to(emb.dtype).float() @ emb.float().t()
    return logit_aggregates(grammar_filter(logits, suppress, ts_silence, flags,
                                           ts_begin, eot, with_grammar), ts_begin)


def fused_logit_aggregates(x, emb, suppress, ts_silence, flags, ts_begin: int,
                           eot: int, with_grammar: bool = True) -> torch.Tensor:
    """(B, 6) f32 aggregates of the filtered logits x . emb^T.

    x: (B, d) hidden states; emb: (V, d) bf16 or f32; suppress: (V,) f32
    additive; ts_silence: (B, V) f32 additive, or None; flags: (B, 4)
    int32, read only with ``with_grammar``. A CPU tensor goes to the plain
    twin, a CUDA tensor to the kernel."""
    if x.device.type == 'cpu':
        return fused_logit_aggregates_ref(x, emb, suppress, ts_silence, flags,
                                          ts_begin, eot, with_grammar)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_logit_aggregates: unsupported device {x.device}')
    b, d = x.shape
    v = emb.shape[0]
    if emb.dtype not in (torch.bfloat16, torch.float32) or not emb.is_contiguous():
        raise TypeError('logit epilogue: emb must be contiguous bf16 or f32')
    if emb.shape[1] != d or (d * emb.element_size()) % 16 or emb.data_ptr() % 16:
        raise ValueError(f'logit epilogue: emb {tuple(emb.shape)} for x '
                         f'{tuple(x.shape)}; rows must be 16-byte multiples')
    if suppress.dtype != torch.float32 or tuple(suppress.shape) != (v,) \
            or not suppress.is_contiguous():
        raise ValueError('logit epilogue: suppress must be contiguous f32 (V,)')
    sil_rs = 0
    if ts_silence is not None:
        if (ts_silence.dtype != torch.float32 or tuple(ts_silence.shape) != (b, v)
                or ts_silence.stride(1) != 1):
            raise ValueError('logit epilogue: ts_silence must be f32 (B, V) rows')
        sil_rs = ts_silence.stride(0)
    if with_grammar and (flags.dtype != torch.int32 or tuple(flags.shape) != (b, 4)
                         or not flags.is_contiguous()):
        raise ValueError('logit epilogue: flags must be contiguous int32 (B, 4)')
    if not (x.device == emb.device == suppress.device):
        raise ValueError('logit epilogue: operands must share a device')
    x = x.to(emb.dtype).contiguous()
    lib = _build.lib()
    part = torch.empty(lib.epilogue_partial_floats(b, v), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((b, 6), dtype=torch.float32, device=x.device)
    _build.check(lib.logit_epilogue(
        x.data_ptr(), emb.data_ptr(), suppress.data_ptr(),
        ts_silence.data_ptr() if ts_silence is not None else None, sil_rs,
        flags.data_ptr() if with_grammar else None, part.data_ptr(),
        out.data_ptr(), _build.dtype_code(emb.dtype), b, d, v, ts_begin, eot,
        int(with_grammar), _build.stream_ptr(x)), 'logit_epilogue')
    _build.launches['logit_epilogue'] += 1
    return out


def select_from_aggregates(agg: torch.Tensor, with_grammar: bool = True):
    """Greedy selection from (B, 6) aggregates: (next token (B,) int64,
    its logprob (B,) f32), exactly the argmax and log_softmax gather of
    the filtered logits with the force-timestamp rule (the total timestamp
    probability beats every text token -> text is banned)."""
    m_t, a_t, s_t, m_s, a_s, s_s = agg.unbind(dim=-1)
    lse_s = m_s + torch.log(s_s)
    force = (lse_s > m_t) if with_grammar else torch.zeros_like(m_t, dtype=torch.bool)
    text_wins = m_t >= m_s                       # first max: text ids are lower
    next_tok = torch.where(force, a_s, torch.where(text_wins, a_t, a_s)).long()
    chosen = torch.where(force, m_s, torch.maximum(m_t, m_s))
    m_all = torch.maximum(m_t, m_s)
    lse_all = m_all + torch.log(s_t * torch.exp(m_t - m_all)
                                + s_s * torch.exp(m_s - m_all))
    return next_tok, chosen - torch.where(force, lse_s, lse_all)
