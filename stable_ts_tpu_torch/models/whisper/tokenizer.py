"""Self-contained Whisper tokenizer: byte-level BPE + special-token layout.

The reference relies on openai-whisper's tiktoken-based tokenizer
(whisper_compatibility.py:310). Here the BPE engine is implemented from
scratch (GPT-2 byte-level scheme) and vocabularies load from either:

- HF format: ``vocab.json`` + ``merges.txt``
- tiktoken format: lines of ``base64(token_bytes) rank``
- a synthetic byte-level vocabulary (offline tests / air-gapped machines)

Special tokens are appended after the base vocabulary in the canonical
Whisper order, reproducing the well-known ids (multilingual: eot=50257,
sot=50258, timestamp_begin=50364; english: eot=50256, sot=50257,
timestamp_begin=50363; large-v3 shifts by one language).
"""
import base64
import json
import os
import re
import string
from functools import cached_property, lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .languages import LANGUAGES, LANGUAGES_V3

# GPT-2 pre-tokenization pattern ('s|'t|... contractions, letter runs,
# number runs, other runs, whitespace runs). The exact pattern needs
# unicode-category classes (\p{L}/\p{N}); the `regex` module provides them.
# The `re` fallback approximates them ([^\W\d_] / \d) — close, but it folds
# non-decimal numerals (Ⅷ, ²) into the punctuation class, so prefer `regex`.
try:
    import regex as _regex
    _PRETOKEN_RE = _regex.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
except ImportError:  # pragma: no cover
    _PRETOKEN_RE = re.compile(
        r"""'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+|\s+(?!\S)|\s+""",
        re.UNICODE,
    )


@lru_cache(maxsize=1)
def byte_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte <-> printable-unicode mapping."""
    printable = (list(range(ord('!'), ord('~') + 1))
                 + list(range(ord('¡'), ord('¬') + 1))
                 + list(range(ord('®'), ord('ÿ') + 1)))
    mapping = {}
    shift = 0
    for b in range(256):
        if b in printable:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + shift)
            shift += 1
    return mapping


class ByteLevelBPE:
    """Minimal GPT-2-style byte-level BPE encoder/decoder.

    ``ranks``: dict mapping token *byte strings* to integer ids. Single-byte
    tokens must all be present; merges are implied by rank ordering (a token
    is producible iff it is in ranks, and lower rank merges first).
    """

    def __init__(self, ranks: Dict[bytes, int]):
        self.ranks = ranks
        self.id_to_token = {v: k for k, v in ranks.items()}
        self._cache: Dict[bytes, List[int]] = {}

    def __len__(self):
        return len(self.ranks)

    def _bpe(self, token: bytes) -> List[int]:
        if token in self._cache:
            return self._cache[token]
        parts: List[bytes] = [bytes([b]) for b in token]
        while len(parts) > 1:
            best_rank = None
            best_i = None
            for i in range(len(parts) - 1):
                merged = parts[i] + parts[i + 1]
                rank = self.ranks.get(merged)
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_i is None:
                break
            parts = (parts[:best_i] + [parts[best_i] + parts[best_i + 1]]
                     + parts[best_i + 2:])
        ids = [self.ranks[p] for p in parts]
        self._cache[token] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for piece in _PRETOKEN_RE.findall(text):
            ids.extend(self._bpe(piece.encode('utf-8')))
        return ids

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return b''.join(self.id_to_token[i] for i in ids if i in self.id_to_token)

    def decode(self, ids: Sequence[int]) -> str:
        return self.decode_bytes(ids).decode('utf-8', errors='replace')


# -- vocabulary loading --------------------------------------------------------------

def load_tiktoken_ranks(path: str) -> Dict[bytes, int]:
    ranks = {}
    with open(path, 'rb') as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def load_hf_vocab(vocab_path: str, merges_path: Optional[str] = None) -> Dict[bytes, int]:
    """Convert HF vocab.json (unicode-mapped tokens) into byte-string ranks."""
    with open(vocab_path, 'r', encoding='utf-8') as f:
        vocab = json.load(f)
    u2b = {u: bytes([b]) for b, u in byte_to_unicode().items()}
    ranks = {}
    for token, idx in vocab.items():
        if token.startswith('<|') and token.endswith('|>'):
            continue  # specials are laid out structurally
        try:
            ranks[b''.join(u2b[ch] for ch in token)] = idx
        except KeyError:
            continue  # non-byte-level artifact token
    return ranks


def synthetic_byte_ranks(extra_merges: Sequence[bytes] = ()) -> Dict[bytes, int]:
    """A minimal valid vocabulary: all 256 bytes plus optional merges.

    Lets every pipeline stage (tokenize -> decode -> word split) run offline;
    real checkpoints just swap in their rank table.
    """
    ranks = {bytes([b]): b for b in range(256)}
    for i, merge in enumerate(extra_merges):
        ranks[merge] = 256 + i
    return ranks


# -- Whisper layout -------------------------------------------------------------------------


class WhisperTokenizer:
    """BPE engine + Whisper special tokens + timing-oriented helpers."""

    TASKS = ('translate', 'transcribe')

    def __init__(
            self,
            ranks: Dict[bytes, int],
            multilingual: bool = True,
            num_languages: int = 99,
            language: Optional[str] = None,
            task: Optional[str] = None,
    ):
        self.bpe = ByteLevelBPE(ranks)
        self.multilingual = multilingual
        self.num_languages = num_languages if multilingual else 99
        self.language = language if multilingual else 'en'
        self.task = task
        lang_codes = list(LANGUAGES_V3 if self.num_languages > 99 else LANGUAGES)
        self._lang_codes = lang_codes[:self.num_languages]

        base_n = len(ranks)
        specials = ['<|endoftext|>', '<|startoftranscript|>']
        specials += [f'<|{code}|>' for code in self._lang_codes]
        specials += ['<|translate|>', '<|transcribe|>', '<|startoflm|>',
                     '<|startofprev|>', '<|nospeech|>', '<|notimestamps|>']
        specials += [f'<|{i * 0.02:.2f}|>' for i in range(1501)]
        self.special_tokens: Dict[str, int] = {}
        next_id = base_n
        for tok in specials:
            self.special_tokens[tok] = next_id
            next_id += 1
        self.n_vocab = next_id

    # -- special ids -----------------------------------------------------------------

    @property
    def eot(self) -> int:
        return self.special_tokens['<|endoftext|>']

    @property
    def sot(self) -> int:
        return self.special_tokens['<|startoftranscript|>']

    @property
    def translate(self) -> int:
        return self.special_tokens['<|translate|>']

    @property
    def transcribe(self) -> int:
        return self.special_tokens['<|transcribe|>']

    @property
    def sot_lm(self) -> int:
        return self.special_tokens['<|startoflm|>']

    @property
    def sot_prev(self) -> int:
        return self.special_tokens['<|startofprev|>']

    @property
    def no_speech(self) -> int:
        return self.special_tokens['<|nospeech|>']

    @property
    def no_timestamps(self) -> int:
        return self.special_tokens['<|notimestamps|>']

    @property
    def timestamp_begin(self) -> int:
        return self.special_tokens['<|0.00|>']

    def to_language_token(self, language: str) -> int:
        token = self.special_tokens.get(f'<|{language}|>')
        if token is None:
            raise KeyError(f'language {language!r} not found in tokenizer')
        return token

    @cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError('this tokenizer has no language specified')
        return self.to_language_token(self.language)

    @cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(self.special_tokens[f'<|{c}|>'] for c in self._lang_codes)

    @cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(self._lang_codes)

    @cached_property
    def sot_sequence(self) -> Tuple[int, ...]:
        seq = [self.sot]
        if self.multilingual:
            seq.append(self.to_language_token(self.language or 'en'))
            seq.append(self.transcribe if self.task != 'translate' else self.translate)
        return tuple(seq)

    @cached_property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids for sound/music annotations to suppress (♪, [, (, etc.)."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += ('<< >> <<< >>> -- --- -( -[ (\' (" (( )) ((( ))) [[ ]] '
                    '{{ }} ♪♪ ♪♪♪').split()
        miscellaneous = set('♩♪♫♬♭♮♯')
        result = set()
        for tok in [' -', " '"]:
            ids = self.bpe.encode(tok)
            if len(ids) == 1:
                result.add(ids[0])
        for symbol in symbols + list(miscellaneous):
            for tok in [symbol, ' ' + symbol]:
                ids = self.bpe.encode(tok)
                if len(ids) == 1:
                    result.add(ids[0])
                elif symbol in miscellaneous and ids:
                    result.add(ids[0])
        return tuple(sorted(result))

    # -- encode / decode ----------------------------------------------------------------

    def encode(self, text: str) -> List[int]:
        return self.bpe.encode(text)

    def decode(self, token_ids: Sequence[int]) -> str:
        token_ids = [t for t in token_ids if t < self.eot]
        return self.bpe.decode(token_ids)

    def decode_with_timestamps(self, token_ids: Sequence[int]) -> str:
        parts = []
        chunk: List[int] = []
        for t in token_ids:
            if t >= self.timestamp_begin:
                if chunk:
                    parts.append(self.decode(chunk))
                    chunk = []
                parts.append(f'<|{(t - self.timestamp_begin) * 0.02:.2f}|>')
            else:
                chunk.append(t)
        if chunk:
            parts.append(self.decode(chunk))
        return ''.join(parts)

    # -- word splitting (for word-level timing) --------------------------------------------

    def split_to_word_tokens(self, tokens: Sequence[int]):
        """Group tokens into display words. CJK-family languages split per
        decoded unicode chunk (no spaces); others split on space/punctuation."""
        if self.language in {'zh', 'ja', 'th', 'lo', 'my', 'yue'}:
            return self.split_tokens_on_unicode(tokens)
        return self.split_tokens_on_spaces(tokens)

    def split_tokens_on_unicode(self, tokens: Sequence[int]):
        decoded_full = self.decode_with_timestamps(tokens)
        replacement = '�'
        words, word_tokens = [], []
        current: List[int] = []
        unicode_offset = 0
        for token in tokens:
            current.append(token)
            decoded = self.decode_with_timestamps(current)
            # A word boundary is reached when the partial decode has no
            # dangling replacement char (i.e. no split UTF-8 sequence).
            if (replacement not in decoded
                    or decoded_full[unicode_offset + decoded.index(replacement)]
                    == replacement):
                words.append(decoded)
                word_tokens.append(current)
                current = []
                unicode_offset += len(decoded)
        if current:
            words.append(self.decode_with_timestamps(current))
            word_tokens.append(current)
        return words, word_tokens

    def split_tokens_on_spaces(self, tokens: Sequence[int]):
        subwords, subword_tokens_list = self.split_tokens_on_unicode(tokens)
        words, word_tokens = [], []
        for subword, subword_tokens in zip(subwords, subword_tokens_list):
            special = subword_tokens[0] >= self.eot
            with_space = subword.startswith(' ')
            punctuation = subword.strip() in string.punctuation
            if special or with_space or punctuation or len(words) == 0:
                words.append(subword)
                word_tokens.append(subword_tokens)
            else:
                words[-1] += subword
                word_tokens[-1].extend(subword_tokens)
        return words, word_tokens


# -- factory ---------------------------------------------------------------------------------

def get_tokenizer(
        multilingual: bool = True,
        num_languages: int = 99,
        language: Optional[str] = None,
        task: Optional[str] = None,
        vocab_path: Optional[str] = None,
        merges_path: Optional[str] = None,
) -> WhisperTokenizer:
    """Build a tokenizer from a vocab file, or a synthetic one if none given.

    ``vocab_path`` may be a tiktoken rank file or an HF vocab.json.
    """
    if language is not None:
        from .languages import get_valid_language
        language = get_valid_language(language, num_languages)
    if vocab_path is None:
        ranks = synthetic_byte_ranks()
    elif vocab_path.endswith('.json'):
        ranks = load_hf_vocab(vocab_path, merges_path)
    else:
        ranks = load_tiktoken_ranks(vocab_path)
    return WhisperTokenizer(ranks, multilingual=multilingual,
                            num_languages=num_languages,
                            language=language, task=task)
