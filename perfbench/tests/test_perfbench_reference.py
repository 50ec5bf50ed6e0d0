"""The reference against the port's plain CPU path at a tiny size.

The reference files import neither the port nor JAX; this test imports
both the port and the reference and holds them to each other: the mel,
the encoder, the teacher-forced decoder, the special ids and the
suppressed ids, and the greedy rules and the served tokens'
log-probabilities on the port's own decode."""
import numpy as np
import pytest
import torch

from perfbench.core import ranks, weights
from perfbench.reference import judge as judge_mod
from perfbench.reference import rules
from perfbench.reference.whisper import log_mel
from stable_ts_tpu_torch.loaders import WhisperTorch
from stable_ts_tpu_torch.models.whisper.decoding import (DecodingOptions,
                                                         build_suppress_list)
from stable_ts_tpu_torch.models.whisper.dims import ModelDimensions
from stable_ts_tpu_torch.models.whisper.load import convert_openai_state_dict
from stable_ts_tpu_torch.models.whisper.model import decoder_apply, encoder_apply
from stable_ts_tpu_torch.ops.mel import log_mel_spectrogram

TINY = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=2,
            n_audio_layer=2, n_vocab=51866, n_text_ctx=448, n_text_state=64,
            n_text_head=2, n_text_layer=2)
HEADS = [(0, 1), (1, 0), (1, 1)]


@pytest.fixture(scope='module')
def pair():
    sd = weights.state_dict(TINY, 7, torch.float32, 'cpu')
    port = WhisperTorch(ModelDimensions(**TINY),
                        convert_openai_state_dict(sd, ModelDimensions(**TINY),
                                                  device='cpu'),
                        device='cpu', ranks=ranks.rank_table(),
                        alignment_heads=HEADS)
    ref = judge_mod.Judge(sd, TINY, ranks.rank_table(), 'cpu')
    return port, ref


def _audio(seconds=20.0, seed=3):
    from perfbench.core.audio import speech_like
    return speech_like(seconds, seed, 'cpu').pcm.astype(np.float32) / 32768.0


def test_mel_matches_port():
    a = torch.from_numpy(_audio())[None]
    ref = log_mel(a, 80)
    port = log_mel_spectrogram(torch.nn.functional.pad(a, (0, 480000 - a.shape[1])),
                               80)[..., :3000]
    assert ref.shape == port.shape
    assert torch.allclose(ref, port, atol=2e-4)


def test_encoder_and_decoder_match_port(pair):
    port, ref = pair
    mel = log_mel(torch.from_numpy(_audio())[None], 80)
    xa_ref = ref.ref.encode(mel)
    xa_port = encoder_apply(port.params.encoder, mel)
    assert torch.allclose(xa_ref, xa_port, atol=1e-4, rtol=1e-4)
    toks = torch.tensor([[50258, 50259, 50360, 40, 41, 42, 50257]])
    lg_ref = ref.ref.decode(toks, xa_ref)
    lg_port, _ = decoder_apply(port.params.decoder, toks, xa_port)
    assert torch.allclose(lg_ref, lg_port, atol=1e-4, rtol=1e-4)


def test_special_and_suppressed_ids_match_port(pair):
    port, ref = pair
    tok = port.get_tokenizer(language='en', task='transcribe')
    sp = ref.sp
    assert (sp['eot'], sp['sot'], sp['en'], sp['transcribe'], sp['translate'],
            sp['sot_prev'], sp['sot_lm'], sp['no_speech'], sp['no_timestamps'],
            sp['ts_begin']) == (tok.eot, tok.sot, tok.language_token, tok.transcribe,
                                tok.translate, tok.sot_prev, tok.sot_lm,
                                tok.no_speech, tok.no_timestamps, tok.timestamp_begin)
    want = set(build_suppress_list(tok, DecodingOptions())) | {tok.no_timestamps}
    assert set(ref.suppress) == want
    assert ref.blank == tok.encode(' ') + [tok.eot]
    for word in ('abcd', 'xyzQRS', 'qXY'):
        assert rules.bpe(' ' + word, ranks.rank_table()) == tok.encode(' ' + word)


def _decode(port, ref, a, sample_len, monkeypatch):
    """The port's greedy decode of one window as a check item, with the
    log-probability its step gave each served token."""
    from stable_ts_tpu_torch.models.whisper import decoding
    steps, select = [], decoding.select_from_aggregates

    def recording(agg, with_grammar=True):
        tok, lp = select(agg, with_grammar)
        steps.append((int(tok[0]), float(lp[0])))
        return tok, lp
    monkeypatch.setattr(decoding, 'select_from_aggregates', recording)
    mel = log_mel(torch.from_numpy(a)[None], 80)
    res = port.decode(mel, DecodingOptions(language='en', sample_len=sample_len))[0]
    item = dict(audio=a, prompt=None, tokens=res.tokens, sample_len=sample_len,
                avg_logprob=res.avg_logprob, no_speech_prob=res.no_speech_prob)
    served = ref._served(item)
    assert [t for t, _ in steps[:len(served)]] == served
    return dict(item, logprobs=[lp for _, lp in steps[:len(served)]])


def test_greedy_rules_accept_the_ports_decode(pair, monkeypatch):
    port, ref = pair
    tok = port.get_tokenizer(language='en', task='transcribe')
    item = _decode(port, ref, _audio(25.0, seed=11), 40, monkeypatch)
    gaps = ref.decode_gaps([item])
    # f32 twins against f32: only the port's int8 self cache rounds
    assert gaps['logit_gap'] < 0.05 and gaps['mean_gap'] < 0.005
    assert gaps['token_logprob_gap'] < 0.005
    assert gaps['avg_logprob_gap'] < 0.005 and gaps['no_speech_gap'] < 0.005
    assert gaps['tokens'] == min(len(item['tokens']) + 1, 40)
    served = ref._served(item)
    worst = [dict(item, judged=[t if i != 3 else tok.timestamp_begin
                                for i, t in enumerate(served)])]
    assert ref.decode_gaps(worst)['logit_gap'] > 0.05
    k = next(i for i, t in enumerate(item['tokens']) if 0 < t < tok.eot)
    moved = [dict(item, tokens=[t - 1 if i == k else t
                                for i, t in enumerate(item['tokens'])])]
    assert ref.decode_gaps(moved)['token_logprob_gap'] > 0.05
    assert ref.decode_gaps([dict(item, logprobs=None)])['token_logprob_gap'] == np.inf


def test_served_logprob_bounds_take_either_score_at_a_tie():
    sp = rules.specials(256, 1)
    ts = sp['ts_begin']
    args = dict(ts_begin=ts, eot=sp['eot'], suppress=[], blank=[sp['eot']])
    logits = torch.zeros(3, ts + 10)
    logits[1, 5] = 8.0                        # step 1: text far ahead
    logits[2, ts + 3] = 3.0                   # step 2: the timestamps win
    history = [ts, 5, ts + 3]
    lo, hi = rules.served_logprob_bounds(logits, history, tie=0.0, **args)
    assert np.array_equal(lo, hi)
    lo_t, hi_t = rules.served_logprob_bounds(logits, history, tie=100.0, **args)
    # step 2: every allowed id (all but the timestamp of step 0) or the
    # timestamps alone; the sign of the margin takes the timestamps
    n_text, n_ts = ts, 9
    every = 3.0 - np.log(n_text + (n_ts - 1) + np.exp(3.0))
    alone = 3.0 - np.log((n_ts - 1) + np.exp(3.0))
    assert lo_t[2] == pytest.approx(every) and hi_t[2] == pytest.approx(alone)
    assert lo[2] == pytest.approx(alone)
    assert lo_t[1] == hi_t[1] == lo[1]                    # text: one score
    assert np.array_equal(rules.served_logprobs(logits, history, **args), lo)


def test_control_reads_worse_than_the_program(pair, monkeypatch):
    port, ref = pair
    items = [_decode(port, ref, _audio(25.0, seed=12), 60, monkeypatch)]
    sd = weights.state_dict(TINY, 7, torch.float32, 'cpu')
    low = judge_mod.Judge(sd, TINY, ranks.rank_table(), 'cpu',
                          weight_format='fp8', kv_bits=4)
    program, control = ref.decode_gaps(items), ref.decode_gaps(low.control_outputs(items))
    for name in ('decode_logprob_gap', 'token_logprob_gap', 'no_speech_gap'):
        assert control[name] > 3 * program[name], (name, program, control)
