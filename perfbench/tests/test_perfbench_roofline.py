"""roofline.py and flops.py against counts made by hand at the cells'
shapes (large-v3: d 1280, 20 heads, 32 + 32 layers, V 51866; 32 windows
a group). Meta tensors carry the shapes; nothing is allocated."""
import pytest
import torch

from perfbench import flops, roofline

D, V, B = 1280, 51866, 32
LARGE_V3 = dict(n_mels=128, n_audio_ctx=1500, n_audio_state=D, n_audio_head=20,
                n_audio_layer=32, n_vocab=V, n_text_ctx=448, n_text_state=D,
                n_text_head=20, n_text_layer=32)


def meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device='meta')


def test_flash_encoder():
    q = meta(B, 1500, D)
    nbytes, ops, peak = roofline.flash_attention(q, q, q, 20, 0.125)
    assert nbytes == 4 * B * 1500 * D * 2
    assert ops == 4 * B * 1500 * 1500 * D
    assert peak == 989e12


def test_self_decode_counts_the_keys_it_reads():
    q = meta(B, D, dtype=torch.float32)
    k = meta(B, 256, D, dtype=torch.int8)
    sc = meta(B, 256, dtype=torch.float32)
    nbytes, ops, peak = roofline.self_attn_decode(q, k, k, sc, sc, 100, 20)
    assert nbytes == B * D * 4 + 2 * B * 101 * D + 2 * B * 101 * 4 + B * D * 4
    assert ops == 4 * B * 101 * D and peak == 67e12


def test_cross_decode_one_layer():
    q = meta(B, D, dtype=torch.float32)
    kv = meta(32, B, 2, 1500, D, dtype=torch.int8)
    sc = meta(32, B, 2, 1500, dtype=torch.float32)
    nbytes, ops, _ = roofline.cross_attn_decode(q, kv, sc, 5, 1500, 20)
    assert nbytes == B * D * 4 + 2 * B * 1500 * D + 2 * B * 1500 * 4 + B * D * 4
    assert ops == 4 * B * 1500 * D


def test_epilogue_and_vocab_proj():
    x = meta(B, D, dtype=torch.float32)
    emb = meta(V, D)
    sup = meta(V, dtype=torch.float32)
    flags = meta(B, 4, dtype=torch.int32)
    nbytes, ops, peak = roofline.fused_logit_aggregates(x, emb, sup, None, flags,
                                                        50365, 50257)
    assert nbytes == B * D * 4 + V * D * 2 + V * 4 + B * 16 + B * 24
    assert ops == 2 * B * V * D and peak == 989e12
    nbytes, ops, _ = roofline.vocab_proj(meta(16, D), emb)
    assert nbytes == 16 * D * 2 + V * D * 2 + 16 * V * 4 and ops == 2 * 16 * V * D


def test_dtw_and_woq():
    nbytes, ops, peak = roofline.dtw_cost(meta(B, 130, 1500, dtype=torch.float32))
    assert nbytes == B * 130 * 1500 * 4 + B * 131 * 1501 * 4 and peak == 67e12
    nbytes, ops, _ = roofline.woq_matmul(meta(8, D), meta(4 * D, D, dtype=torch.int8),
                                         meta(4 * D, dtype=torch.float32))
    assert nbytes == 8 * D * 2 + 4 * D * D + 4 * D * 4 + 8 * 4 * D * 2
    assert ops == 2 * 8 * 4 * D * D


def test_rules_cover_the_kernel_wrappers():
    from stable_ts_tpu_torch import ops
    import importlib
    for mod, attr in roofline.RULES:
        assert callable(getattr(importlib.import_module(f'{ops.__name__}.{mod}'), attr))


def test_model_flops_by_hand():
    enc = (2 * 128 * D * 3 * 3000 + 2 * D * D * 3 * 1500
           + 32 * (24 * 1500 * D * D + 4 * 1500 * 1500 * D))
    assert flops.encoder_window(LARGE_V3) == enc
    assert enc == pytest.approx(2.26e12, rel=0.01)
    tok = 32 * (28 * D * D + 4 * 11 * D + 4 * 1500 * D) + 2 * D * V
    assert flops.decoder_token(LARGE_V3, 10) == tok
    window = (flops.cross_kv_window(LARGE_V3) + flops.decoder_tokens(LARGE_V3, 0, 3)
              + flops.decoder_tokens(LARGE_V3, 3, 119))
    assert flops.greedy_window(LARGE_V3, 3, 120) == window
    assert flops.cross_kv_window(LARGE_V3) == 32 * 4 * 1500 * D * D
