"""The port's CUDA kernels against their plain twins. They need an NVIDIA
GPU with nvcc (the kernels build at first use) and skip without one; run
them on the card with ``python -m pytest tests/test_torch_kernels_gpu.py``.
chip_smoke.py runs the same comparisons at the large-v3 shapes."""
import collections

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


@pytest.mark.parametrize('shape', [(1, 226, 1500), (3, 40, 333), (1, 1, 1), (2, 448, 1500),
                                   (1, 1, 4096), (1, 0, 7)])
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


def test_dtw_kernel_reruns_counts_and_limits(cuda):
    """Bit-identical reruns (fixed scan order, no atomics), one count per
    call, and a raise beyond M = 4096 columns."""
    from stable_ts_tpu_torch.ops.dtw import dtw_cost
    x = _randn(cuda, 2, 226, 1500)
    before = _build.launches['dtw_cost']
    got = dtw_cost(x)
    again = dtw_cost(x)
    torch.cuda.synchronize()
    assert _build.launches['dtw_cost'] == before + 2
    assert torch.equal(got, again)
    with pytest.raises(ValueError, match='4096'):
        dtw_cost(_randn(cuda, 1, 3, 4097))


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


def _row_cache(gen, kind, rows, ctx, d):
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    k, v = _randn(gen, rows, ctx, d), _randn(gen, rows, ctx, d)
    if kind == torch.int8:
        (k, ks), (v, vs) = quantize_rows(k), quantize_rows(v)
        return k, v, ks, vs
    return k.to(kind), v.to(kind), None, None


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n_keys', [1, 63, 64, 65, 201, 448, 8192])
@pytest.mark.parametrize('dh', [32, 64])
def test_self_decode_kernel_chunks_and_reruns(cuda, dtype, n_keys, dh):
    """Each warp of the self entry holds a quarter of the keys, in one chunk
    or in double-buffered chunks of 8 KB of K (n_keys 8192): within 1e-5 of
    the twin, and a rerun equal bit for bit (the warps merge in order)."""
    from stable_ts_tpu_torch.ops.self_attn import self_attn_decode, self_attn_decode_ref
    n_head = 20
    d = n_head * dh
    k, v, ks, vs = _row_cache(cuda, dtype, 2, max(n_keys, 448), d)
    q = _randn(cuda, 2, d) * dh ** -0.5
    before = _build.launches['self_attn_decode']
    got = self_attn_decode(q, k, v, ks, vs, n_keys - 1, n_head)
    again = self_attn_decode(q, k, v, ks, vs, n_keys - 1, n_head)
    torch.cuda.synchronize()
    assert _build.launches['self_attn_decode'] == before + 2
    assert torch.equal(got, again)
    assert _rel(got, self_attn_decode_ref(q, k, v, ks, vs, n_keys - 1, n_head)) <= 1e-5


@pytest.mark.parametrize('beam', [False, True])
def test_self_decode_kernel_every_decode_pos(cuda, beam):
    """Every pos of a large-v3 decode (448 keys, int8 cache, d_head 64): the
    shared memory a launch takes grows with pos and passes the 48 KB that
    needs the opt-in on the way."""
    from stable_ts_tpu_torch.ops.self_attn import self_attn_decode, self_attn_decode_ref
    n_head, rows, g, ctx = 20, 5 if beam else 1, 5, 448
    d = n_head * 64
    k, v, ks, vs = _row_cache(cuda, torch.int8, rows, ctx, d)
    q = _randn(cuda, rows, d) * 0.125
    kw = dict(anc=_anc(cuda, rows, g, ctx, 0, 'random'), q_per_kv=g) if beam else {}
    for pos in range(ctx):
        if beam:
            kw['anc'][:, pos] = torch.arange(rows, device='cuda', dtype=torch.int32)
        got = self_attn_decode(q, k, v, ks, vs, pos, n_head, **kw)
        ref = self_attn_decode_ref(q, k, v, ks, vs, pos, n_head, **kw)
        assert _rel(got, ref) <= 1e-5, pos


@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize('n_keys', [1, 64, 65, 448, 8192])
@pytest.mark.parametrize('g', [2, 5])
@pytest.mark.parametrize('dh', [32, 64])
def test_self_decode_beam_kernel_chunks_and_reruns(cuda, dtype, n_keys, g, dh):
    """The beam entry reads each chunk's ancestry, then copies each key from
    its ancestor row: random ancestry, within 1e-5 of the twin, a rerun
    equal bit for bit."""
    from stable_ts_tpu_torch.ops.self_attn import self_attn_decode, self_attn_decode_ref
    n_head, rows = 20, 2 * g
    d = n_head * dh
    ctx = max(n_keys, 448)
    k, v, ks, vs = _row_cache(cuda, dtype, rows, ctx, d)
    q = _randn(cuda, rows, d) * dh ** -0.5
    anc = _anc(cuda, rows, g, ctx, n_keys - 1, 'random')
    got = self_attn_decode(q, k, v, ks, vs, n_keys - 1, n_head, anc=anc, q_per_kv=g)
    again = self_attn_decode(q, k, v, ks, vs, n_keys - 1, n_head, anc=anc, q_per_kv=g)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = self_attn_decode_ref(q, k, v, ks, vs, n_keys - 1, n_head, anc=anc, q_per_kv=g)
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


def _check_aggregates(got, ref):
    # maxima and sums within 1e-3 relative (f32 sums in another order);
    # argmax ids equal
    for col in (0, 2, 3, 5):
        assert ((got[:, col] - ref[:, col]).abs()
                <= 1e-3 * ref[:, col].abs().clamp_min(1.0)).all(), col
    assert torch.equal(got[:, [1, 4]], ref[:, [1, 4]])


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
    _check_aggregates(got, fused_logit_aggregates_ref(*args, ts_begin, eot, grammar))


@pytest.mark.parametrize('b', [1, 5, 8, 9, 17, 64, 65])
def test_logit_epilogue_wgmma_rows_reruns_and_counts(cuda, b):
    """The bf16 tensor-core kernel at every N variant (8, 16, 32, 64) and with
    a second chunk of x rows (65): the twin's aggregates, a rerun equal bit
    for bit (fixed merge order), one count per call."""
    from stable_ts_tpu_torch.ops.logit_epilogue import (fused_logit_aggregates,
                                                        fused_logit_aggregates_ref)
    v, d, ts_begin, eot = 51866, 1280, 50365, 50257
    args = _epilogue_inputs(cuda, b, v, d, ts_begin, torch.bfloat16, True)
    before = _build.launches['logit_epilogue']
    got = fused_logit_aggregates(*args, ts_begin, eot, True)
    again = fused_logit_aggregates(*args, ts_begin, eot, True)
    torch.cuda.synchronize()
    assert _build.launches['logit_epilogue'] == before + 2
    assert torch.equal(got, again)
    _check_aggregates(got, fused_logit_aggregates_ref(*args, ts_begin, eot, True))


def test_logit_epilogue_wgmma_ties_bans_and_last_tile(cuda):
    """Exact ties across tiles, warps and lane groups go to the lower id; a
    part whose every id is banned folds to m = -1e9 at its first id; ids of
    the last, partial tile win; with_grammar=False takes no flags."""
    from stable_ts_tpu_torch.ops.logit_epilogue import (fused_logit_aggregates,
                                                        fused_logit_aggregates_ref)
    v, d, ts_begin, eot = 51866, 1280, 50365, 50257
    x = _randn(cuda, 4, d, dtype=torch.bfloat16)
    emb = (_randn(cuda, v, d) * 0.05).to(torch.bfloat16)
    unit = (x.float() / x.float().norm(dim=1, keepdim=True)).to(torch.bfloat16)
    # (text pair, timestamp pair) of equal rows: id = 64 tile + 16 warp + lane
    # group (+ 8 for a thread's second row)
    pairs = [((64 * 3 + 16 * 1 + 2, 64 * 500 + 16 * 3 + 8 + 5), (50368, 51864)),
             ((64 * 10 + 2, 64 * 10 + 16 * 3 + 8 + 7), (50400 + 17, 51840 + 9)),
             ((64 * 700 + 16 * 2 + 8 + 1, 64 * 701 + 0), (ts_begin, ts_begin + 1))]
    for k, ((t0, t1), (s0, s1)) in enumerate(pairs):
        emb[t0] = emb[t1] = unit[k] * 8
        emb[s0] = emb[s1] = unit[k] * 4
    # row 3: the text part's maximum at id 100, the timestamp part's at the
    # last id (the partial tile's)
    emb[100] = unit[3] * 2
    emb[v - 1] = unit[3] * 8
    suppress = torch.zeros(v, device='cuda')
    for grammar in (False, True):
        flags = None
        if grammar:
            # row 0 bans every timestamp, the others nothing
            flags = torch.tensor([[0, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 0],
                                  [0, 0, 0, 0]], dtype=torch.int32, device='cuda')
        args = (x, emb, suppress, None, flags, ts_begin, eot, grammar)
        got = fused_logit_aggregates(*args)
        ref = fused_logit_aggregates_ref(*args)
        torch.cuda.synchronize()
        _check_aggregates(got, ref)
        for k, ((t0, _), (s0, _)) in enumerate(pairs):
            assert got[k, 1].item() == t0
            if not (grammar and k == 0):
                assert got[k, 4].item() == s0
        assert got[3, 1].item() == 100 and got[3, 4].item() == v - 1
        if grammar:
            assert got[0, 3].item() == -1e9 and got[0, 4].item() == ts_begin
            assert abs(got[0, 5].item() - (v - ts_begin)) <= 1e-3 * (v - ts_begin)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('m,k,n', [(1, 1280, 3840), (5, 5120, 1280), (16, 1280, 5120),
                                   (17, 1280, 1280), (230, 1280, 5120), (1500, 5120, 1280),
                                   (3, 80, 100), (70, 96, 33), (1, 1280, 5120),
                                   (5, 1280, 5120), (17, 1280, 5120), (1500, 1280, 5120),
                                   (64, 112, 65), (65, 112, 130), (257, 112, 65)])
def test_woq_kernel_matches_twin(cuda, dtype, m, k, n):
    """Both regimes (M <= 16 and the tiled one) and ragged M, N; the same
    exact products summed in f32 in another order."""
    from stable_ts_tpu_torch.models.whisper.quantization import quantize_weight
    from stable_ts_tpu_torch.ops.woq_matmul import woq_matmul, woq_matmul_ref
    q, scale = quantize_weight(_randn(cuda, n, k) * 0.05)
    x = _randn(cuda, m, k, dtype=dtype)
    before = _build.launches['woq_matmul']
    got = woq_matmul(x, q, scale)
    torch.cuda.synchronize()
    assert _build.launches['woq_matmul'] == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    # the wrapper casts to x's dtype: bf16 outputs may sit one bf16 step
    # (2^-8 relative) apart; f32 outputs within 1e-5
    ref = woq_matmul_ref(x, q, scale).to(dtype)
    assert _rel(got, ref) <= (2 ** -8 if dtype == torch.bfloat16 else 1e-5)


@pytest.mark.parametrize('m,k,n', [(1, 1280, 5120), (5, 1280, 5120), (16, 1280, 5120),
                                   (17, 1280, 5120), (230, 1280, 5120), (1500, 1280, 5120),
                                   (1, 5120, 1280), (5, 1280, 3840), (1500, 5120, 1280),
                                   (8, 112, 65), (9, 112, 130), (32, 112, 65), (33, 112, 130),
                                   (64, 112, 65), (65, 112, 130), (128, 16, 65),
                                   (257, 112, 130), (230, 1280, 1280), (64, 1280, 1280),
                                   (40, 512, 320), (3, 2048, 200)])
def test_woq_wgmma_kernel_sums_and_reruns(cuda, m, k, n):
    """The bf16 tensor-core kernel's f32 output (before the wrapper's cast)
    at every M regime (x tiles of 8, 16, 32 and 64 rows with four
    warpgroups along K where 4 slabs divide K, else one; 192-row tiles
    above 64), K split over clusters of 1-8 blocks in both regimes, and
    ragged N and K: within 1e-5 of the largest output (the same exact
    products summed in another order), and a rerun equal bit for bit
    (fixed-order sums, no atomics)."""
    from stable_ts_tpu_torch.models.whisper.quantization import quantize_weight
    from stable_ts_tpu_torch.ops.woq_matmul import _woq_cuda, woq_matmul_ref
    q, scale = quantize_weight(_randn(cuda, n, k) * 0.05)
    x = _randn(cuda, m, k, dtype=torch.bfloat16)
    got = _woq_cuda(x, q, scale)
    again = _woq_cuda(x, q, scale)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, woq_matmul_ref(x, q, scale)) <= 1e-5


def test_woq_kernel_raises_outside_its_contract(cuda):
    from stable_ts_tpu_torch.ops.woq_matmul import woq_matmul
    x = _randn(cuda, 2, 64)
    scale = torch.ones(32, device='cuda')
    with pytest.raises(TypeError, match='int8'):
        woq_matmul(x, _randn(cuda, 32, 64), scale)
    with pytest.raises(ValueError, match='multiple of 16'):
        woq_matmul(_randn(cuda, 2, 40), torch.zeros((32, 40), dtype=torch.int8,
                                                    device='cuda'), scale)
    with pytest.raises(ValueError, match='scale'):
        woq_matmul(x, torch.zeros((32, 64), dtype=torch.int8, device='cuda'),
                   scale.double())


@pytest.mark.parametrize('windows,g', [(1, 1), (2, 1), (1, 5), (3, 2), (1, 11)])
def test_int4_cross_kernels_match_twin(cuda, windows, g):
    """Packed int4 K/V through the cross entry (g = 1) and the group entry
    (g > 1), each counted under its own name."""
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops.cross_attn import (cross_attn_decode,
                                                    cross_attn_decode_ref, pack_int4)
    layers, s, d, n_head = 2, 1500, 1280, 20
    vals, sc = quantize_rows(_randn(cuda, layers, windows, 2, s, d), bits=4)
    q = _randn(cuda, windows * g, d) * 0.125
    name = 'cross_attn_decode_group_int4' if g > 1 else 'cross_attn_decode_int4'
    before = _build.launches[name]
    got = cross_attn_decode(q, pack_int4(vals), sc, 1, 1450, n_head, q_per_kv=g,
                            bits=4)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    ref = cross_attn_decode_ref(q, vals[1, :, 0], vals[1, :, 1], sc[1, :, 0],
                                sc[1, :, 1], 1450, n_head, q_per_kv=g)
    # same bf16 rounding points; a weight may round to the neighbouring bf16
    assert _rel(got, ref) <= 1e-3


def test_int4_cross_kernels_raise_on_a_wrong_packing(cuda):
    from stable_ts_tpu_torch.ops.cross_attn import cross_attn_decode
    d, n_head = 128, 2
    q = _randn(cuda, 1, d)
    sc = torch.ones((1, 1, 2, 10), device='cuda')
    packed = torch.zeros((1, 1, 2, 10, d // 2), dtype=torch.int8, device='cuda')
    with pytest.raises(ValueError, match='bits=4'):
        cross_attn_decode(q, packed.float(), sc, 0, 10, n_head, bits=4)
    with pytest.raises(ValueError, match='bits=4'):
        cross_attn_decode(_randn(cuda, 1, d + 1), packed, sc, 0, 10, n_head, bits=4)
    with pytest.raises(ValueError, match='width'):
        cross_attn_decode(q, packed, sc, 0, 10, n_head)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('m,v,d', [(1, 51866, 1280), (5, 51866, 1280), (16, 51866, 1280),
                                   (40, 4100, 384), (3, 2048, 64)])
def test_vocab_kernel_matches_twin(cuda, dtype, m, v, d):
    from stable_ts_tpu_torch.ops.vocab_proj import vocab_proj, vocab_proj_ref
    x = _randn(cuda, m, d, dtype=dtype)
    emb = (_randn(cuda, v, d) * 0.05).to(dtype)
    before = _build.launches['vocab_proj']
    got = vocab_proj(x, emb)
    torch.cuda.synchronize()
    assert _build.launches['vocab_proj'] == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, v)
    # f32 sums of the same exact products, in another order
    assert _rel(got, vocab_proj_ref(x, emb)) <= 1e-4


@pytest.mark.parametrize('m', [1, 5, 16, 64, 100, 200, 256])
def test_vocab_wgmma_kernel_rows_and_reruns(cuda, m):
    """The bf16 tensor-core kernel at every N variant (8, 16, 32, 64 and two to
    four N = 64 tiles over one embedding stage): within 1e-4 of the largest
    logit, and a rerun equal bit for bit (fixed-order sums, no atomics)."""
    from stable_ts_tpu_torch.ops.vocab_proj import vocab_proj, vocab_proj_ref
    x = _randn(cuda, m, 1280, dtype=torch.bfloat16)
    emb = (_randn(cuda, 51866, 1280) * 0.02).to(torch.bfloat16)
    got = vocab_proj(x, emb)
    again = vocab_proj(x, emb)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert _rel(got, vocab_proj_ref(x, emb)) <= 1e-4


def test_vocab_kernel_raises_outside_its_contract(cuda):
    from stable_ts_tpu_torch.ops.vocab_proj import vocab_proj
    emb = _randn(cuda, 2048, 64)
    with pytest.raises(ValueError, match='2-D'):
        vocab_proj(_randn(cuda, 1, 1, 64), emb)
    with pytest.raises(TypeError, match='bf16 or f32'):
        vocab_proj(_randn(cuda, 1, 64), emb.half())
    with pytest.raises(ValueError, match='16-byte'):
        vocab_proj(_randn(cuda, 1, 6), _randn(cuda, 2048, 6))
    with pytest.raises(ValueError, match='256 rows'):
        vocab_proj(_randn(cuda, 257, 64), emb)


def _flash_views(gen, b, t, s, n_head, dh, dtype):
    """q, k, v as column slices of wider projections (row strides 3d, 2d),
    as views of fused projections would be."""
    d = n_head * dh
    q = _randn(gen, b, t, 3 * d, dtype=dtype)[..., d:2 * d]
    kv = _randn(gen, b, s, 2 * d, dtype=dtype)
    return q, kv[..., :d], kv[..., d:]


# the bf16 kernels' 64-row tiles against T and S: ragged edges (T 63, 65,
# 230; S 77, 150, 1500 = 23 x 64 + 28) and single rows, at batch 2 (TMA fills
# rows past T or S with zeros per batch row; the kernels mask them)
_RAGGED = [(1, 1), (63, 1500), (100, 77), (300, 300)] + [
    (t, s) for t in (1, 63, 65, 230) for s in (1, 150, 1500)
    if (t, s) not in ((1, 1), (63, 1500))]


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('dh', [32, 64])
@pytest.mark.parametrize('t,s', _RAGGED)
def test_flash_backward_kernels_match_twin(cuda, dtype, tol, dh, t, s):
    """The forward's output and lse, then flash_attn_bwd_dkv and
    flash_attn_bwd_dq on the kernel's own output against the twins, and a
    rerun of each equal bit for bit (no atomics: one block sums each row in
    a fixed order). f32: sums in another order; bf16: the same rounding
    points as the twins, outputs rounded to bf16."""
    from stable_ts_tpu_torch.ops import flash_attn as fa
    n_head = 3
    scale = dh ** -0.5
    q, k, v = _flash_views(cuda, 2, t, s, n_head, dh, dtype)
    o, lse = fa._flash_cuda(q, k, v, n_head, scale, return_lse=True)
    o_ref, lse_ref = fa.flash_attention_ref(q, k, v, n_head, scale, return_lse=True)
    assert _rel(o, o_ref) <= tol
    assert lse.shape == (2, n_head, t) and lse.dtype == torch.float32
    assert _rel(lse, lse_ref) <= 1e-5
    do = _randn(cuda, 2, t, n_head * dh, dtype=dtype)
    delta = fa.attention_delta(o, do, n_head)
    before = dict(_build.launches)
    dk, dv = fa._bwd_dkv_cuda(q, k, v, lse, do, delta, n_head, scale)
    dq = fa._bwd_dq_cuda(q, k, v, lse, do, delta, n_head, scale)
    torch.cuda.synchronize()
    assert _build.launches['flash_attn_bwd_dkv'] == before.get('flash_attn_bwd_dkv', 0) + 1
    assert _build.launches['flash_attn_bwd_dq'] == before.get('flash_attn_bwd_dq', 0) + 1
    refs = fa.flash_attention_bwd_ref(q, k, v, o, lse, do, n_head, scale)
    for name, got, ref in zip('qkv', (dq, dk, dv), refs):
        assert got.dtype == dtype and got.shape == ref.shape, name
        if s == 1 and name != 'v':
            # one key: P = 1, so dS = dP - D = 0 up to rounding
            assert got.float().abs().max().item() <= 1e-4, name
        else:
            assert _rel(got, ref) <= tol, name
    dk2, dv2 = fa._bwd_dkv_cuda(q, k, v, lse, do, delta, n_head, scale)
    dq2 = fa._bwd_dq_cuda(q, k, v, lse, do, delta, n_head, scale)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2) and torch.equal(dq, dq2)


def test_flash_backward_raises_outside_its_contract(cuda):
    from stable_ts_tpu_torch.ops import flash_attn as fa
    q, k, v = (_randn(cuda, 1, n, 96) for n in (4, 9, 9))
    o, lse = fa._flash_cuda(q, k, v, 3, 0.125, return_lse=True)
    delta = fa.attention_delta(o, o, 3)
    with pytest.raises(ValueError, match='d_head 32 or 64'):
        fa.flash_attention_bwd(q, k, v, o, lse, o, 2, 0.125)   # d_head 48
    with pytest.raises(TypeError, match='one dtype'):
        fa._bwd_dq_cuda(q, k.to(torch.bfloat16), v, lse, o, delta, 3, 0.125)
    with pytest.raises(ValueError, match='logsumexp'):
        fa._bwd_dq_cuda(q, k, v, None, o, delta, 3, 0.125)
    with pytest.raises(ValueError, match='contiguous'):
        fa._bwd_dkv_cuda(q, k, v, lse, _randn(cuda, 1, 96, 4).transpose(1, 2),
                         delta, 3, 0.125)


@pytest.mark.parametrize('dtype,tol', [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize('expanded', [False, True], ids=['random_dO', 'expanded_dO'])
def test_flash_function_cuda_grads_match_cpu(cuda, dtype, tol, expanded):
    """Autograd through FlashAttention on the card (the kernels) against the
    same on the CPU (the twins): dO from a weighted sum, or expanded with
    stride 0 from a plain .sum()."""
    from stable_ts_tpu_torch.ops.flash_attn import flash_attention
    n_head, dh = 4, 64
    q, k, v = _flash_views(cuda, 2, 70, 150, n_head, dh, dtype)
    w = _randn(cuda, 2, 70, n_head * dh)
    grads = []
    for dev in ('cuda', 'cpu'):
        leaves = [x.detach().to(dev).requires_grad_() for x in (q, k, v)]
        before = _build.launches['flash_attn_bwd_dq']
        out = flash_attention(*leaves, n_head, dh ** -0.5)
        assert out.grad_fn is not None
        loss = out.sum() if expanded else (out.float() * w.to(dev)).sum()
        loss.backward()
        if dev == 'cuda':
            assert _build.launches['flash_attn_bwd_dq'] == before + 1
        grads.append([x.grad.cpu() for x in leaves])
    for name, got, ref in zip('qkv', *grads):
        assert _rel(got, ref) <= tol, name


def _cross_inputs(gen, kind, layers, windows, s, d):
    """Cross K/V (L, B, 2, S, d) of one kind with its (L, B, 2, S) scales,
    and the unpacked values the twin reads."""
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops.cross_attn import pack_int4
    raw = _randn(gen, layers, windows, 2, s, d)
    if kind == 'int4':
        vals, sc = quantize_rows(raw, bits=4)
        return pack_int4(vals), vals, sc, 4
    if kind == 'int8':
        vals, sc = quantize_rows(raw)
        return vals, vals, sc, 8
    kv = raw.to(torch.bfloat16 if kind == 'bf16' else torch.float32)
    return kv, kv, torch.ones((layers, windows, 2, s), device='cuda'), 8


@pytest.mark.parametrize('kind', ['int8', 'int4', 'bf16', 'f32'])
@pytest.mark.parametrize('g', [1, 5, 8, 9])
@pytest.mark.parametrize('s', [1500, 1499, 10, 5])
def test_cross_cluster_kernel_matches_twin(cuda, kind, g, s):
    """Both cross entries run one kernel whose 8 key chunks of a head share a
    thread-block cluster: ragged and short key counts (5 keys leave 3 of the
    8 chunks empty), g query rows over one or two blocks of 8, every K/V
    type. Within 1e-3 of the largest output (the same bf16 rounding points
    as the twin; a weight may round to the neighbouring bf16), and a rerun
    equal bit for bit (the chunks combine in a fixed order, no atomics)."""
    from stable_ts_tpu_torch.ops.cross_attn import cross_attn_decode, cross_attn_decode_ref
    d, n_head, windows = 1280, 20, 2
    kv, vals, sc, bits = _cross_inputs(cuda, kind, 2, windows, 1500, d)
    q = _randn(cuda, windows * g, d) * 0.125
    name = ('cross_attn_decode_group' if g > 1 else 'cross_attn_decode') + (
        '_int4' if bits == 4 else '')
    before = _build.launches[name]
    got = cross_attn_decode(q, kv, sc, 1, s, n_head, q_per_kv=g, bits=bits)
    again = cross_attn_decode(q, kv, sc, 1, s, n_head, q_per_kv=g, bits=bits)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 2
    assert torch.equal(got, again)
    ref = cross_attn_decode_ref(q, vals[1, :, 0], vals[1, :, 1], sc[1, :, 0],
                                sc[1, :, 1], s, n_head, q_per_kv=g)
    assert _rel(got, ref) <= 1e-3


@pytest.mark.parametrize('kind', ['int8', 'int4', 'bf16', 'f32'])
def test_cross_cluster_kernel_d_head_32(cuda, kind):
    from stable_ts_tpu_torch.ops.cross_attn import cross_attn_decode, cross_attn_decode_ref
    d, n_head = 128, 4
    kv, vals, sc, bits = _cross_inputs(cuda, kind, 1, 3, 300, d)
    for g in (1, 3):
        q = _randn(cuda, 3 * g, d) * 0.18
        got = cross_attn_decode(q, kv, sc, 0, 299, n_head, q_per_kv=g, bits=bits)
        ref = cross_attn_decode_ref(q, vals[0, :, 0], vals[0, :, 1], sc[0, :, 0],
                                    sc[0, :, 1], 299, n_head, q_per_kv=g)
        assert _rel(got, ref) <= 1e-3


def test_cross_kernel_raises_beyond_its_key_limit(cuda):
    from stable_ts_tpu_torch.ops.cross_attn import cross_attn_decode
    from stable_ts_tpu_torch.ops.self_attn import MAX_KEYS_CROSS
    d, n_head = 128, 2
    kv = torch.zeros((1, 1, 2, MAX_KEYS_CROSS + 1, d), device='cuda')
    sc = torch.ones((1, 1, 2, MAX_KEYS_CROSS + 1), device='cuda')
    with pytest.raises(ValueError, match='at most'):
        cross_attn_decode(_randn(cuda, 1, d), kv, sc, 0, MAX_KEYS_CROSS + 1, n_head)


# -- the greedy step's CUDA graph (models/whisper/step_graph.py) ---------------------

@pytest.mark.parametrize('dtype', [torch.int8, torch.bfloat16, torch.float32])
@pytest.mark.parametrize('pos', [0, 1, 200, 255])
def test_self_decode_kernel_reads_its_position_on_the_device(cuda, dtype, pos):
    """The self entry given its position as a device int64 (sized for the
    whole cache, each warp's share taken in the kernel) equals the entry
    given the int, bit for bit: the same shares, chunks and merge."""
    from stable_ts_tpu_torch.ops.self_attn import self_attn_decode
    rows, ctx, d, n_head = 32, 256, 1280, 20
    k, v, ks, vs = _row_cache(cuda, dtype, rows, ctx, d)
    q = _randn(cuda, rows, d) * 0.125
    before = _build.launches['self_attn_decode']
    want = self_attn_decode(q, k, v, ks, vs, pos, n_head)
    got = self_attn_decode(q, k, v, ks, vs, torch.tensor(pos, device='cuda'), n_head)
    torch.cuda.synchronize()
    assert _build.launches['self_attn_decode'] == before + 2
    assert torch.equal(got, want)


@pytest.mark.parametrize('kind', ['int8', 'int4', 'bf16'])
@pytest.mark.parametrize('layer', [0, 2])
def test_cross_decode_kernel_reads_its_buffers_on_the_device(cuda, kind, layer):
    """The g = 1 cross entry given its K/V and scale buffers' addresses on
    the device reads those buffers at the layout's offsets (layer 0: offset
    0) and equals the entry given the buffers themselves, bit for bit."""
    from stable_ts_tpu_torch.models.whisper.model import quantize_rows
    from stable_ts_tpu_torch.ops.cross_attn import (cross_attn_decode,
                                                    cross_attn_decode_indirect,
                                                    pack_int4)
    layers, b, s, d, n_head = 3, 32, 1500, 1280, 20

    def buffers():
        kv = _randn(cuda, layers, b, 2, s, d)
        if kind == 'bf16':
            return kv.to(torch.bfloat16), torch.ones((layers, b, 2, s), device='cuda')
        vals, sc = quantize_rows(kv, bits=4 if kind == 'int4' else 8)
        return (pack_int4(vals) if kind == 'int4' else vals), sc
    bits = 4 if kind == 'int4' else 8
    layout_kv, layout_sc = buffers()
    kv, sc = buffers()
    q = _randn(cuda, b, d) * 0.125
    bases = torch.tensor([kv.data_ptr(), sc.data_ptr()], device='cuda')
    before = _build.launches['cross_attn_decode' + ('_int4' if bits == 4 else '')]
    got = cross_attn_decode_indirect(q, layout_kv, layout_sc, bases, layer, s,
                                     n_head, bits=bits)
    want = cross_attn_decode(q, kv, sc, layer, s, n_head, bits=bits)
    torch.cuda.synchronize()
    assert _build.launches['cross_attn_decode' + ('_int4' if bits == 4 else '')] == before + 2
    assert torch.equal(got, want)


def _rank_table(n=50257):
    """A synthetic byte-level rank table the size of the multilingual
    vocabulary's (chip_smoke.py's)."""
    ranks = {bytes([b]): b for b in range(256)}
    i = 256
    while len(ranks) < n:
        ranks[b'\x00' + i.to_bytes(3, 'big')] = i
        i += 1
    return ranks


@pytest.fixture(scope='module')
def wide_model():
    """A random bf16 model of large-v3's width (d 1280, 20 heads, its
    vocabulary) with 4 decoder layers: the greedy step's kernels at the
    shapes of a real decode."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: CUDA graphs have no CPU mode')
    import dataclasses
    from stable_ts_tpu_torch.loaders import WhisperTorch
    from stable_ts_tpu_torch.models.whisper.dims import (OPENAI_MODEL_DIMS,
                                                         ModelDimensions)
    from stable_ts_tpu_torch.models.whisper.model import init_params
    dims = dataclasses.replace(ModelDimensions(**OPENAI_MODEL_DIMS['large-v3']),
                               n_audio_layer=1, n_text_layer=4)
    return WhisperTorch(dims, init_params(dims, seed=0, dtype=torch.bfloat16,
                                          device='cuda'),
                        device='cuda', name='large-v3-4', ranks=_rank_table())


def _greedy(model, feats, sample_len, monkeypatch, eager=False):
    """One greedy group: each step's (token, log-probability) as the loop
    selects them, the summed log-probabilities, the recorder's counters."""
    from stable_ts_tpu_torch import profiling
    from stable_ts_tpu_torch.models.whisper import decoding, step_graph
    steps, select = [], decoding.select_from_aggregates

    def recording_select(agg, with_grammar=True):
        tok, lp = select(agg, with_grammar)
        steps.append((tok, lp))
        return tok, lp
    with monkeypatch.context() as m:
        m.setattr(decoding, 'select_from_aggregates', recording_select)
        if eager:
            m.setattr(step_graph, 'graphable', lambda *a, **k: False)
        with profiling.recording() as rec:
            pending = model.decode_launch(feats, decoding.DecodingOptions(
                language='en', temperature=0.0, sample_len=sample_len))
    torch.cuda.synchronize()
    return (torch.stack([t for t, _ in steps]), torch.stack([lp for _, lp in steps]),
            pending.outputs[1], collections.Counter(rec.counters))


@pytest.mark.parametrize('sample_len,cache_len', [(100, 128), (140, 256)])
def test_greedy_step_graph_equals_eager(cuda, wide_model, monkeypatch, sample_len,
                                        cache_len):
    """A 32-row greedy group whose steps replay a CUDA graph gives the eager
    loop's tokens, step log-probabilities and sums, bit for bit."""
    feats = _randn(cuda, 32, 1500, 1280, dtype=torch.bfloat16)
    tok, lp, sums, counts = _greedy(wide_model, feats, sample_len, monkeypatch)
    e_tok, e_lp, e_sums, e_counts = _greedy(wide_model, feats, sample_len,
                                            monkeypatch, eager=True)
    steps = len(tok) - 1      # decoder steps: the last token needs none
    assert counts['decode.graph_replays'] + counts['decode.eager_steps'] == steps
    assert counts['decode.graph_replays'] >= steps - 2
    assert e_counts['decode.graph_replays'] == 0 and e_counts['decode.eager_steps'] == steps
    runner = wide_model.params.decoder._step_graph
    assert runner.cache['k'].shape[2] == cache_len
    assert torch.equal(tok, e_tok)
    assert torch.equal(lp, e_lp)
    assert torch.equal(sums, e_sums)


def test_step_graph_second_group_equals_eager(cuda, wide_model, monkeypatch):
    """A second group with other features through the same captured runner,
    its cross K/V at another address, equals its own eager run: the cache
    is written anew and the graph reads the new cross K/V."""
    _greedy(wide_model, _randn(cuda, 32, 1500, 1280, dtype=torch.bfloat16), 60,
            monkeypatch)
    runner = wide_model.params.decoder._step_graph
    first = runner.bases.tolist()
    # the first group's freed cross K/V held, so the second's lands elsewhere
    held = torch.empty(4 * 32 * 2 * 1500 * 1280, dtype=torch.int8, device='cuda')
    feats = _randn(cuda, 32, 1500, 1280, dtype=torch.bfloat16) * 2.0
    tok, lp, sums, counts = _greedy(wide_model, feats, 60, monkeypatch)
    assert runner.bases.tolist() != first
    del held
    e_tok, e_lp, e_sums, _ = _greedy(wide_model, feats, 60, monkeypatch, eager=True)
    assert counts['decode.graph_captures'] == counts['decode.eager_steps'] == 0
    assert counts['decode.graph_replays'] == len(tok) - 1
    assert torch.equal(tok, e_tok) and torch.equal(lp, e_lp) and torch.equal(sums, e_sums)


def test_step_graph_counts_the_eager_launches(cuda, wide_model, monkeypatch):
    """``_build.launches`` after a graphed loop (one that captures, one that
    only replays) equals the eager loop's."""
    feats = _randn(cuda, 32, 1500, 1280, dtype=torch.bfloat16)
    wide_model.params.decoder._step_graph = None        # a fresh capture
    counts = []
    for eager in (True, False, False):
        _build.reset_launch_counts()
        _greedy(wide_model, feats, 40, monkeypatch, eager=eager)
        counts.append(_build.launch_counts())
    assert counts[0]['self_attn_decode'] == counts[0]['cross_attn_decode'] == 4 * 39
    assert counts[1] == counts[0] and counts[2] == counts[0]


@pytest.mark.parametrize('options', [dict(temperature=0.5), dict(temperature=0.5, best_of=2),
                                     dict(temperature=0.0, beam_size=2)],
                         ids=['sampled', 'best_of', 'beam'])
def test_sampled_and_beam_decodes_replay_no_graph(cuda, wide_model, options):
    from stable_ts_tpu_torch import profiling
    from stable_ts_tpu_torch.models.whisper import decoding
    feats = _randn(cuda, 4, 1500, 1280, dtype=torch.bfloat16)
    with profiling.recording() as rec:
        wide_model.decode_launch(feats, decoding.DecodingOptions(
            language='en', sample_len=8, **options))
    assert rec.counters['decode.eager_steps'] > 0
    assert rec.counters.get('decode.graph_replays', 0) == 0
    assert rec.counters.get('decode.graph_captures', 0) == 0


def test_locate_replays_no_graph(cuda, wide_model):
    """``locate``'s confirmation decode steps stay eager."""
    import numpy as np
    from stable_ts_tpu_torch import profiling
    audio = (np.random.default_rng(3).standard_normal(16000 * 20) * 0.1).astype(np.float32)
    with profiling.recording() as rec:
        wide_model.locate(audio, [300, 301], language='en', mode=1,
                          probability_threshold=0.0, verbose=None)
    assert rec.counters['decode.eager_steps'] > 0
    assert rec.counters.get('decode.graph_replays', 0) == 0
    assert rec.counters.get('decode.graph_captures', 0) == 0
