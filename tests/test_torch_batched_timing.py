"""The batched driver's word timing in the port against stable_ts_tpu on
the CPU: the batched legacy weights, the device scorers of the full
capture (dynamic heads, with and without the refinement's peak targets,
and the 'new' aligner), the batched DTW traceback and the next-token
probabilities, each against JAX's function on the same seeded inputs, f32,
within 1e-6 absolute plus 1e-5 of the value (sums in another order), with
the selected heads equal; then whole ``transcribe_batched`` requests of
the tiny model (``from_jax`` of JAX's ``load_test_model()``) with known
heads over a short tail window, with no heads, and with the 'new'
aligner: text, word-level SRT bytes and every word time equal."""
import numpy as np
import pytest
import torch

torch.set_num_threads(2)
SR = 16000
HEADS = [(0, 1), (1, 0), (1, 1)]
SOT = 3
ATOL, RTOL = 1e-6, 1e-5


@pytest.fixture(scope='module', autouse=True)
def jax_env():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('STABLE_TS_TPU_CROSS', 'interpret')
        mp.setenv('STABLE_TS_TPU_SELFKV', '1')
        mp.setenv('STABLE_TS_TPU_EPI', '0')
        yield


def _bf16(shape, seed, scale=2.0):
    """Seeded values on the bf16 grid (the capture's dtype), as f32."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _close(got: torch.Tensor, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_legacy_weights_batched_matches_jax():
    """Three windows: 20, 12 and 20 token rows of 24, and 96, 70 and 40
    real frames of 96 (two crops narrower than the frames)."""
    import jax.numpy as jnp
    from stable_ts_tpu.models.whisper import timing as jax_timing
    from stable_ts_tpu_torch.models.whisper import timing
    qks = _bf16((3, 3, 24, 96), seed=5)
    lens, rows = [96, 70, 40], [20, 12, 20]
    got = timing.legacy_weights_batched(
        torch.from_numpy(qks).to(torch.bfloat16), torch.tensor(lens),
        torch.tensor(rows), SOT, 1.0, 7)
    ref = jax_timing.legacy_weights_batched(
        jnp.asarray(qks, jnp.bfloat16), jnp.asarray(lens), jnp.asarray(rows),
        SOT, 1.0, 7)
    _close(got, ref)


def _jax_dynamic_heads(qks, qk_len, peaks, k):
    """The per-token heads JAX's ``dynamic_weights_device`` selects: its own
    lines (timing.py:357-368) up to ``lax.top_k``."""
    import jax
    import jax.numpy as jnp
    L, H, T, F = qks.shape
    w = jnp.asarray(qks).reshape(L * H, T, F)[:, SOT:-1, :]
    col_ok = jnp.arange(F)[None, None, :] < qk_len
    w = jnp.where(col_ok, jax.nn.softmax(jnp.where(col_ok, w, -jnp.inf), axis=-1), 0.0)
    pk = (jnp.argmax(w, axis=-1, keepdims=True).astype(jnp.float32) if peaks is None
          else jnp.asarray(peaks)[None, :, None])
    scores = jnp.sum(jnp.abs(pk - jnp.arange(F)[None, None, :]) / 1500.0 * w, axis=-1)
    return np.asarray(jax.lax.top_k(-scores.T, k)[1])


@pytest.mark.parametrize('qk_len', [96, 70])
@pytest.mark.parametrize('row_count', [20, 12])
@pytest.mark.parametrize('with_peaks', [False, True], ids=['own_peaks', 'peaks'])
def test_dynamic_weights_device_matches_jax(row_count, qk_len, with_peaks):
    import jax.numpy as jnp
    from stable_ts_tpu.models.whisper import timing as jax_timing
    from stable_ts_tpu_torch.models.whisper import timing
    qks = _bf16((3, 4, 24, 96), seed=11)
    peaks = None
    if with_peaks:
        jumps = np.sort(np.random.default_rng(1).integers(0, qk_len, row_count))
        ji = np.pad(jumps, (0, 1), constant_values=qk_len)
        peaks = np.zeros(24 - SOT - 1, np.float32)
        peaks[:row_count] = ji[:-1] + (ji[1:] - ji[:-1]) * 0.5
    got = timing.dynamic_weights_device(
        torch.from_numpy(qks), qk_len, row_count,
        None if peaks is None else torch.from_numpy(peaks), SOT, 1.0, 7, 5)
    ref = jax_timing.dynamic_weights_device(
        jnp.asarray(qks), jnp.int32(qk_len), jnp.int32(row_count),
        None if peaks is None else jnp.asarray(peaks), SOT, 1.0,
        medfilt_width=7, heads_count=5)
    _close(got, ref)
    w = torch.from_numpy(qks).reshape(12, 24, 96)[:, SOT:-1].float()
    col_ok = torch.arange(96) < qk_len
    w = torch.where(col_ok, torch.softmax(torch.where(col_ok, w, -torch.inf), -1), 0.0)
    idx = timing.dynamic_top_heads(w, None if peaks is None else torch.from_numpy(peaks), 5)
    assert np.array_equal(idx.numpy(), _jax_dynamic_heads(qks, qk_len, peaks, 5))


SETTINGS = dict(w_colnorm=1.0, w_rownorm=1.0, w_coverage=0.5)


@pytest.mark.parametrize('qk_len', [96, 70])
@pytest.mark.parametrize('row_count', [20, 12])
def test_new_aligner_matrix_device_matches_jax(row_count, qk_len):
    """The matrix within tolerance of JAX's, and JAX's top-k heads,
    recovered one at a time from its matrices at k = 1..5 (k·M_k -
    (k-1)·M_(k-1) is the k-th head's column-normalized weights), are the
    port's, in order."""
    import jax.numpy as jnp
    from stable_ts_tpu.models.whisper import timing as jax_timing
    from stable_ts_tpu_torch.models.whisper import timing
    qks = _bf16((3, 4, 24, 96), seed=12)

    def jax_matrix(k):
        return np.asarray(jax_timing.new_aligner_matrix_device(
            jnp.asarray(qks), jnp.int32(qk_len), jnp.int32(row_count), SOT,
            1.0, medfilt_width=7, topk=k, **SETTINGS))

    got = timing.new_aligner_matrix_device(torch.from_numpy(qks), qk_len,
                                           row_count, SOT, 1.0, 7, 6, **SETTINGS)
    _close(got, jax_matrix(6))
    t = torch.from_numpy(qks)
    idx, w = timing.new_aligner_top_heads(t, qk_len, 1.0, 7, 12, **SETTINGS,
                                          n_rows=SOT + row_count + 1)
    norm = w / torch.linalg.vector_norm(w, dim=-2, keepdim=True).clamp_min(1e-30)
    per_head = norm[:, SOT:-1].numpy()
    jax_idx, prev = [], 0
    for k in range(1, 6):
        m_k = jax_matrix(k)
        head = k * m_k - (k - 1) * prev
        jax_idx.append(int(idx[np.abs(per_head - head).max(axis=(1, 2)).argmin()]))
        prev = m_k
    assert jax_idx == idx[:5].tolist()


@pytest.mark.parametrize('head_chunk', [1, 5, 7])
def test_new_aligner_matrix_device_chunks_are_bit_identical(head_chunk):
    from stable_ts_tpu_torch.models.whisper import timing
    t = torch.from_numpy(_bf16((3, 4, 24, 96), seed=13))
    args = (t, 70, 12, SOT, 1.0, 7, 6, 1.0, 1.0, 0.5)
    assert torch.equal(timing.new_aligner_matrix_device(*args, head_chunk=head_chunk),
                       timing.new_aligner_matrix_device(*args, head_chunk=12))


def test_dtw_jumps_batched_matches_jax():
    """Three windows' costs (one launch of the DTW's twin over 20 token
    rows and 96 frames), walked from corners (20, 96), (12, 70) and
    (17, 40), the rows past each corner padding; and a start one column
    past the matrix, which JAX's clamped reads walk from the last column."""
    import jax.numpy as jnp
    from stable_ts_tpu.ops.dtw import dtw_jumps_device
    from stable_ts_tpu_torch.ops.dtw import dtw_cost, dtw_jumps_batched
    x = np.random.default_rng(3).standard_normal((3, 20, 96)).astype(np.float32)
    cost = dtw_cost(torch.from_numpy(x)).numpy()
    for rows, cols in (([20, 12, 17], [96, 70, 40]), ([20, 12, 17], [97, 70, 40])):
        got = dtw_jumps_batched(cost, rows, cols)
        ref = np.asarray(dtw_jumps_device(jnp.asarray(cost), jnp.asarray(rows),
                                          jnp.asarray(cols)))
        assert got.dtype == np.int32 and np.array_equal(got, ref)


def _logits_with_ties():
    rng = np.random.default_rng(0)
    # a coarse grid makes equal logits common: the rank's tie rule matters
    logits = np.round(rng.standard_normal((2, 9, 40)) * 2) / 2
    tokens = rng.integers(0, 30, (2, 9))
    tokens[0, 3] = 35          # a next token past the text vocabulary
    return logits.astype(np.float32), tokens


def test_next_token_probs_match_jax():
    from stable_ts_tpu.batched import (_next_token_probs as jax_probs,
                                       _next_token_probs_and_ranks as jax_ranks)
    from stable_ts_tpu_torch.models.whisper.timing import (
        _next_token_probs, _next_token_probs_and_ranks)
    logits, tokens = _logits_with_ties()
    lt, tt = torch.from_numpy(logits), torch.from_numpy(tokens)
    _close(_next_token_probs(lt, tt, 30), jax_probs(logits, tokens.astype(np.int32), 30))
    probs, ranks = _next_token_probs_and_ranks(lt, tt, 30)
    ref_probs, ref_ranks = jax_ranks(logits, tokens.astype(np.int32), 30)
    _close(probs, ref_probs)
    assert ranks.dtype == torch.int32
    assert np.array_equal(ranks.numpy(), np.asarray(ref_ranks))


def _words(result):
    return [(w.word, w.start, w.end) for s in result.segments for w in s.words]


def _assert_same(got, ref):
    assert got.text == ref.text
    assert got.to_srt_vtt(word_level=True) == ref.to_srt_vtt(word_level=True)
    assert _words(got) == _words(ref) and len(_words(got)) > 0


def _noise(seconds, seed):
    return (np.random.default_rng(seed).standard_normal(SR * seconds) * 0.15
            ).astype(np.float32)


@pytest.mark.parametrize('heads,options', [
    (HEADS, {}),
    (None, dict(dynamic_heads=True)),
    (None, dict(dynamic_heads='3,2')),
    (HEADS, dict(aligner='new')),
    (HEADS, dict(aligner={'topk': 4, 'w_coverage': 0.5})),
], ids=['known_heads_short_tail', 'no_heads_dynamic_true', 'no_heads_dynamic_3_2',
        'aligner_new', 'aligner_dict'])
def test_batched_word_timing_matches_jax(heads, options):
    """50 s of noise, one full window and a 20-s tail, in one group of
    two: known heads (the batched legacy weights over a crop), no heads
    (6 dynamic heads, and 3 heads refined once against the previous
    jumps), and the 'new' aligner with its defaults and a dict."""
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu_torch.loaders import from_jax
    jax_model = load_jax(alignment_heads=heads)
    port_model = from_jax(jax_model, device='cpu')
    audio = _noise(50, seed=31)
    kw = dict(language='en', temperature=0, verbose=None, batch_size=2, **options)
    _assert_same(port_model.transcribe_batched(audio, **kw),
                 jax_model.transcribe_batched(audio, **kw))


def _tone_fixture():
    """70 s: 8 s of tone, 4 s of silence, six times (JAX's fixture)."""
    t = np.arange(SR * 8) / SR
    tone = (np.sin(2 * np.pi * 440 * t) * 0.4).astype(np.float32)
    return np.concatenate([tone, np.zeros(SR * 4, np.float32)] * 6)[:SR * 70]


def test_jax_capture_gives_jax_words_on_the_tone_fixture(monkeypatch):
    """Two beams in a group of three windows on JAX's tone fixture: one
    word of the port's own run starts 1.18 s from JAX's. Fed JAX's own
    selected capture, the port's batched word timing (legacy weights, the
    DTW cost, the host traceback, word assembly) gives JAX's words, times
    and probabilities exactly: only the bf16 capture differs (f32
    products summed in another order, rounded to bf16), and the DTW path
    crosses the silence at 68-70 s on a near-tie."""
    import copy
    import stable_ts_tpu.batched as jax_batched
    from stable_ts_tpu.loaders import load_test_model as load_jax
    from stable_ts_tpu.models.whisper import timing as jax_timing
    from stable_ts_tpu_torch import batched
    from stable_ts_tpu_torch.loaders import from_jax
    from stable_ts_tpu_torch.models.whisper import timing
    from stable_ts_tpu_torch.ops.dtw import dtw_cost
    jax_model = load_jax(alignment_heads=HEADS)
    port_model = from_jax(jax_model, device='cpu')
    captures, compared = [], []
    jax_weights = jax_timing.legacy_weights_batched
    jax_finish = jax_batched._finish_word_timing

    def record_capture(sel, qk_lens, row_counts, *args):
        captures.append(np.asarray(sel))
        return jax_weights(sel, qk_lens, row_counts, *args)

    def finish_both(model, tok, pending, metas, segments, *args):
        mine = copy.deepcopy(segments)
        qks = torch.from_numpy(captures.pop(0).astype(np.float32)).to(torch.bfloat16)
        pad = qks.shape[1] - len(pending['todo'])
        mats = timing.legacy_weights_batched(
            qks, torch.tensor(pending['max_qk_lens'] + [1] * pad),
            torch.tensor(pending['row_counts'] + [1] * pad),
            pending['sot_len'], 1.0, 7)
        port_pending = dict(
            pending, tok_probs=torch.from_numpy(np.array(pending['tok_probs'])),
            cost=dtw_cost(-mats), ready=None, stream=None)
        batched._finish_word_timing(port_model, port_pending, metas, mine, *args)
        jax_finish(model, tok, pending, metas, segments, *args)
        compared.append((mine, segments))

    monkeypatch.setattr(jax_timing, 'legacy_weights_batched', record_capture)
    monkeypatch.setattr(jax_batched, '_finish_word_timing', finish_both)
    jax_model.transcribe_batched(_tone_fixture(), language='en', temperature=0,
                                 verbose=None, beam_size=2, batch_size=3)
    assert compared and not captures
    n_words = 0
    for mine, theirs in compared:
        for segs_mine, segs_theirs in zip(mine, theirs):
            for a, b in zip(segs_mine or [], segs_theirs or []):
                assert a['words'] == b['words']
                n_words += len(a['words'])
    assert n_words > 0
