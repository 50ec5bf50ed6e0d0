"""The traffic: deterministic in the seed, inside its stated parameters,
the same sizes for every seed; the rank table's words."""
import json
from pathlib import Path

import numpy as np
import pytest

from perfbench.core import audio, ranks
from perfbench.core.cell import _load_module

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC = ROOT / 'perfbench' / 'traffic'
SEEDS = (0, 2**31 + 977, 12345678901)


def _kind(mix):
    params = json.loads((TRAFFIC / f'{mix}.json').read_text())
    mod = _load_module(ROOT / 'perfbench' / 'generators' / f"{params['kind']}.py",
                       f"test_kind_{params['kind']}")
    return params, mod


@pytest.mark.parametrize('seed', SEEDS)
def test_speech_is_the_seeds(seed):
    a = audio.speech_like(40.0, (seed, 3), 'cpu')
    b = audio.speech_like(40.0, (seed, 3), 'cpu')
    c = audio.speech_like(40.0, (seed, 4), 'cpu')
    assert a.pcm.dtype == np.int16 and len(a.pcm) == 40 * 16000
    assert np.array_equal(a.pcm, b.pcm) and not np.array_equal(a.pcm, c.pcm)
    starts, ends = a.bursts[:, 0], a.bursts[:, 1]
    lengths, gaps = (ends - starts)[:-1] / 16000, (starts[1:] - ends[:-1]) / 16000
    assert lengths.min() >= 1.0 and lengths.max() <= 6.0
    assert gaps.min() >= 0.2 - 1e-4 and gaps.max() <= 1.5
    assert a.voiced_s == pytest.approx((ends - starts).sum() / 16000)
    inside = np.zeros(len(a.pcm), bool)
    for s, e in a.bursts:
        inside[s:e] = True
    assert not a.pcm[~inside].any() and np.abs(a.pcm[inside]).mean() > 100


def test_longform_mix():
    p, mod = _kind('longform')
    assert len(p['minutes']) == len(p['sample_len'])
    assert 12 <= min(p['minutes']) and max(p['minutes']) <= 40
    assert 96 <= min(p['sample_len']) and max(p['sample_len']) <= 144
    lg = np.log(p['minutes'])
    assert abs(np.median(lg) - np.log(np.sqrt(12 * 40))) < 0.1     # log-uniform
    sizes = [mod.Workload(p, {}, s, 'cpu').sizes() for s in SEEDS]
    assert sizes[0] == sizes[1] == sizes[2]


def test_rank_table_words():
    table = ranks.rank_table()
    assert len(table) == ranks.N_BASE and sorted(table.values()) == list(range(ranks.N_BASE))
    from stable_ts_tpu_torch.models.whisper.tokenizer import WhisperTokenizer
    tok = WhisperTokenizer(table, num_languages=100, language='en', task='transcribe')
    ids = np.random.default_rng(0).integers(256, ranks.N_BASE, 20000)
    words = tok.decode(ids.tolist()).split()
    assert 1.3 <= len(ids) / len(words) <= 1.6
    for w in ranks.word_tokens()[::997]:
        assert tok.encode(' ' + w) == [table[(' ' + w).encode()]]
