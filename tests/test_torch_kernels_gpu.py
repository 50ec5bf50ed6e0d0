"""The port's CUDA kernels against their plain twins. They need an NVIDIA
GPU with nvcc (the kernels build at first use) and skip without one; run
them on the card with ``python -m pytest tests/test_torch_kernels_gpu.py``.
chip_smoke.py runs the same comparisons at the large-v3 shapes."""
import pytest
import torch

from stable_ts_tpu_torch import _build


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device='cuda').manual_seed(0)


def _randn(gen, *shape, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device='cuda').to(dtype)


def _rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('t,s,n_head,d', [(1500, 1500, 20, 1280), (37, 150, 2, 64),
                                          (1, 65, 4, 128)])
def test_flash_kernel_matches_twin(cuda, dtype, tol, t, s, n_head, d):
    from stable_ts_tpu_torch.ops.flash_attn import flash_attention, flash_attention_ref
    q, k, v = (_randn(cuda, 2, n, d, dtype=dtype) for n in (t, s, s))
    scale = (d // n_head) ** -0.5
    before = _build.launches['flash_attn']
    got = flash_attention(q, k, v, n_head, scale)
    torch.cuda.synchronize()
    assert _build.launches['flash_attn'] == before + 1
    assert got.dtype == dtype
    # bf16: the output rounds to bf16 (2^-8 relative) in both
    assert _rel(got, flash_attention_ref(q, k, v, n_head, scale)) <= tol


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize('pos', [0, 200, 447])
def test_self_decode_kernel_matches_twin(cuda, dtype, pos):
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops.self_attn import (self_attn_decode,
                                                   self_attn_decode_ref)
    b, ctx, d, n_head = 2, 448, 1280, 20
    k, v = _randn(cuda, b, ctx, d), _randn(cuda, b, ctx, d)
    if dtype == torch.int8:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
    else:
        k, v, ks, vs = k.to(dtype), v.to(dtype), None, None
    q = _randn(cuda, b, d) * 0.125
    got = self_attn_decode(q, k, v, ks, vs, pos, n_head)
    assert _rel(got, self_attn_decode_ref(q, k, v, ks, vs, pos, n_head)) <= 1e-5


@pytest.mark.parametrize('quant', [True, False])
def test_cross_decode_kernel_matches_twin(cuda, quant):
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops.cross_attn import (cross_attn_decode,
                                                    cross_attn_decode_ref)
    layers, b, s, d, n_head = 3, 2, 1500, 1280, 20
    kv = _randn(cuda, layers, b, 2, s, d)
    sc = torch.ones((layers, b, 2, s), device='cuda')
    if quant:
        kv, sc = quantize_rows(kv)
    q = _randn(cuda, b, d) * 0.125
    got = cross_attn_decode(q, kv, sc, 1, 1400, n_head)
    ref = cross_attn_decode_ref(q, kv[1, :, 0], kv[1, :, 1], sc[1, :, 0],
                                sc[1, :, 1], 1400, n_head)
    # same bf16 rounding points; a weight may round to the neighbouring bf16
    assert _rel(got, ref) <= 1e-3


@pytest.mark.parametrize('shape', [(1, 226, 1500), (3, 40, 333), (1, 1, 1)])
def test_dtw_kernel_matches_twin_exactly(cuda, shape):
    from stable_ts_tpu_torch.ops.dtw import dtw_cost, dtw_cost_ref, dtw_jumps
    x = _randn(cuda, *shape)
    got, ref = dtw_cost(x), dtw_cost_ref(x)
    # f64 prefix sums rounded once: the same f32 costs in any scan order
    assert torch.equal(got, ref)
    n, m = shape[1:]
    for bi in range(shape[0]):
        assert (dtw_jumps(got[bi].cpu().numpy(), n, m)
                == dtw_jumps(ref[bi].cpu().numpy(), n, m)).all()


@pytest.mark.parametrize('quant', [True, False])
@pytest.mark.parametrize('windows,g', [(1, 5), (3, 2), (2, 8), (1, 11)])
def test_cross_group_kernel_matches_twin(cuda, quant, windows, g):
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops.cross_attn import (cross_attn_decode,
                                                    cross_attn_decode_ref)
    layers, s, d, n_head = 2, 1500, 1280, 20
    kv = _randn(cuda, layers, windows, 2, s, d)
    sc = torch.ones((layers, windows, 2, s), device='cuda')
    if quant:
        kv, sc = quantize_rows(kv)
    q = _randn(cuda, windows * g, d) * 0.125
    before = _build.launches['cross_attn_decode_group']
    got = cross_attn_decode(q, kv, sc, 1, 1450, n_head, q_per_kv=g)
    torch.cuda.synchronize()
    assert _build.launches['cross_attn_decode_group'] == before + 1
    ref = cross_attn_decode_ref(q, kv[1, :, 0], kv[1, :, 1], sc[1, :, 0],
                                sc[1, :, 1], 1450, n_head, q_per_kv=g)
    # same bf16 rounding points; a weight may round to the neighbouring bf16
    assert _rel(got, ref) <= 1e-3


def _anc(gen, rows, g, ctx, pos, pattern):
    local = torch.arange(rows, device='cuda') % g
    if pattern == 'own':
        anc = local[:, None].expand(rows, ctx)
    elif pattern == 'first':
        anc = torch.zeros((rows, ctx), dtype=torch.long, device='cuda')
    else:
        anc = torch.randint(0, g, (rows, ctx), generator=gen, device='cuda')
    anc = anc.to(torch.int32).contiguous()
    anc[:, pos] = local.to(torch.int32)
    return anc


@pytest.mark.parametrize('dtype', [torch.int8, torch.float32])
@pytest.mark.parametrize('g,pos,pattern', [(5, 200, 'random'), (2, 0, 'own'),
                                           (3, 447, 'first'), (1, 37, 'own')])
def test_self_decode_beam_kernel_matches_twin(cuda, dtype, g, pos, pattern):
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops.self_attn import (self_attn_decode,
                                                   self_attn_decode_ref)
    rows, ctx, d, n_head = 2 * g, 448, 1280, 20
    k, v = _randn(cuda, rows, ctx, d), _randn(cuda, rows, ctx, d)
    if dtype == torch.int8:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
    else:
        ks = vs = None
    q = _randn(cuda, rows, d) * 0.125
    anc = _anc(cuda, rows, g, ctx, pos, pattern)
    before = _build.launches['self_attn_decode_beam']
    got = self_attn_decode(q, k, v, ks, vs, pos, n_head, anc=anc, q_per_kv=g)
    torch.cuda.synchronize()
    assert _build.launches['self_attn_decode_beam'] == before + 1
    ref = self_attn_decode_ref(q, k, v, ks, vs, pos, n_head, anc=anc, q_per_kv=g)
    assert _rel(got, ref) <= 1e-5


def test_self_decode_beam_kernel_raises_beyond_its_limits(cuda):
    from stable_ts_tpu_torch.ops.self_attn import self_attn_decode
    d, n_head = 128, 2
    k = _randn(cuda, 4, 8200, d)
    q = _randn(cuda, 4, d)
    anc = torch.zeros((4, 8200), dtype=torch.int32, device='cuda')
    with pytest.raises(ValueError, match='at most'):
        self_attn_decode(q, k, k, None, None, 8195, n_head, anc=anc, q_per_kv=2)
    with pytest.raises(ValueError, match='divide'):
        self_attn_decode(q, k, k, None, None, 10, n_head, anc=anc, q_per_kv=3)
    with pytest.raises(ValueError, match='anc'):
        self_attn_decode(q, k, k, None, None, 10, n_head, anc=anc.long(), q_per_kv=2)


def _epilogue_inputs(gen, b, v, d, ts_begin, dtype, silence):
    x = _randn(gen, b, d, dtype=dtype)
    emb = (_randn(gen, v, d) * 0.05).to(dtype)
    suppress = torch.where(torch.rand(v, generator=gen, device='cuda') < 0.05,
                           -1e9, 0.0)
    sil = None
    if silence:
        sil = torch.zeros((b, v), device='cuda')
        banned = torch.rand((b, v - ts_begin), generator=gen, device='cuda') < 0.3
        sil[:, ts_begin:] = torch.where(banned, -1e9, 0.0)
    rows = torch.arange(b, device='cuda')
    text_ban = rows % 3 == 1
    ts_ban = rows % 3 == 2
    has_ts = rows % 2 == 0
    floor = (rows * 97) % ((v - ts_begin) // 2)
    flags = torch.stack([text_ban.long(), ts_ban.long(), has_ts.long(), floor], 1)
    return x, emb, suppress, sil, flags.int()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('b,silence,grammar', [(1, True, True), (5, True, True),
                                               (9, False, True), (3, True, False)])
def test_logit_epilogue_kernel_matches_twin(cuda, dtype, b, silence, grammar):
    from stable_ts_tpu_torch.ops.logit_epilogue import (fused_logit_aggregates,
                                                        fused_logit_aggregates_ref)
    v, d, ts_begin, eot = 51866, 1280, 50365, 50257
    args = _epilogue_inputs(cuda, b, v, d, ts_begin, dtype, silence)
    before = _build.launches['logit_epilogue']
    got = fused_logit_aggregates(*args, ts_begin, eot, grammar)
    torch.cuda.synchronize()
    assert _build.launches['logit_epilogue'] == before + 1
    ref = fused_logit_aggregates_ref(*args, ts_begin, eot, grammar)
    # maxima and sums within 1e-3 relative (f32 sums in another order);
    # argmax ids equal
    for col in (0, 2, 3, 5):
        assert ((got[:, col] - ref[:, col]).abs()
                <= 1e-3 * ref[:, col].abs().clamp_min(1.0)).all(), col
    assert torch.equal(got[:, [1, 4]], ref[:, [1, 4]])
