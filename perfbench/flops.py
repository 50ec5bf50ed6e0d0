"""Model operations of the useful work, from the dims alone (a multiply-add
counts two). Padding rows, padded windows and repeated work are the
caller's to leave out: it passes only real windows and real tokens."""

N_AUDIO = 1500   # encoder positions of a 30-s window
N_MEL_FRAMES = 3000


def encoder_window(dims: dict) -> float:
    """One 30-s window through the convolution stem and the encoder."""
    d, n = dims['n_audio_state'], N_AUDIO
    stem = 2 * dims['n_mels'] * d * 3 * N_MEL_FRAMES + 2 * d * d * 3 * n
    layer = 24 * n * d * d + 4 * n * n * d
    return stem + dims['n_audio_layer'] * layer


def cross_kv_window(dims: dict) -> float:
    """The decoder's cross-attention keys and values of one window."""
    d = dims['n_text_state']
    return dims['n_text_layer'] * 4 * N_AUDIO * d * d


def decoder_token(dims: dict, pos: int) -> float:
    """One token at position ``pos`` through the decoder and the logits:
    the self-attention's projections and its ``pos + 1`` keys, the
    cross-attention's query and output projections and its 1500 keys, the
    MLP, and the tied output projection."""
    d = dims['n_text_state']
    layer = 28 * d * d + 4 * (pos + 1) * d + 4 * N_AUDIO * d
    return dims['n_text_layer'] * layer + 2 * d * dims['n_vocab']


def decoder_tokens(dims: dict, start: int, count: int) -> float:
    """``count`` tokens at positions ``start`` .. ``start + count - 1``."""
    return sum(decoder_token(dims, p) for p in range(start, start + count))


def greedy_window(dims: dict, n_prefix: int, n_sampled: int) -> float:
    """A window's decode: its cross K/V, the prefix, and one step for each
    sampled token after the first (the prefix's last logits give it)."""
    return (cross_kv_window(dims) + decoder_tokens(dims, 0, n_prefix)
            + decoder_tokens(dims, n_prefix, max(n_sampled - 1, 0)))


def timing_pass(dims: dict, n_tokens: int) -> float:
    """A teacher-forced word-timing pass over ``n_tokens`` real tokens."""
    return cross_kv_window(dims) + decoder_tokens(dims, 0, n_tokens)
