"""Canonical cross-attention alignment heads per OpenAI Whisper model.

These are the public per-model head masks shipped by openai/whisper
(whisper/__init__.py `_ALIGNMENT_HEADS`): a boolean (n_text_layer,
n_text_head) array compressed with gzip and base85-encoded. The reference
relies on whisper's `model.set_alignment_heads` for its default word-timing
heads (reference timing.py:105-107); without this table every checkpoint
would silently fall back to dynamic head selection and produce different
default timings.

The blobs are self-validating: gzip carries a CRC, so a corrupted constant
fails loudly at decode time (covered by tests/test_alignment_heads.py).
"""
import base64
import gzip
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

_ALIGNMENT_HEADS = {
    "tiny.en": b"ABzY8J1N>@0{>%R00Bk>$p{7v037`oCl~+#00",
    "tiny": b"ABzY8bu8Lr0{>%RKn9Fp%m@SkK7Kt=7ytkO",
    "base.en": b"ABzY8;40c<0{>%RzzG;p*o+Vo09|#PsxSZm00",
    "base": b"ABzY8KQ!870{>%RzyTQH3`Q^yNP!>##QT-<FaQ7m",
    "small.en": b"ABzY8>?_)10{>%RpeA61k&I|OI3I$65C{;;pbCHh0B{qLQ;+}v00",
    "small": b"ABzY8DmU6=0{>%Rpa?J`kvJ6qF(V^F86#Xh7JUGMK}P<N0000",
    "medium.en": b"ABzY8usPae0{>%R7<zz_OvQ{)4kMa0BMw6u5rT}kRKX;$NfYBv00*Hl@qhsU00",
    "medium": b"ABzY8B0Jh+0{>%R7}kK1fFL7w6%<-Pf*t^=N)Qr&0RR9",
    "large-v1": b"ABzY8r9j$a0{>%R7#4sLmoOs{s)o3~84-RPdcFk!JR<kSfC2yj",
    "large-v2": b"ABzY8zd+h!0{>%R7=D0pU<_bnWW*tkYAhobTNnu$jnkEkXqp)j;w1Tzk)UH3X%SZd&fFZ2fC2yj",
    "large-v3": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large": b"ABzY8gWO1E0{>%R7(9S+Kn!D~%ngiGaR?*L!iJG9p-nab0JQ=-{D1-g00",
    "large-v3-turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
    "turbo": b"ABzY8j^C+e0{>%RARaKHP%t(lGR*)0g!tONPyhe`",
}


def model_names() -> List[str]:
    return list(_ALIGNMENT_HEADS)


@lru_cache(maxsize=None)
def get_alignment_heads(name: str, n_text_layer: int,
                        n_text_head: int) -> Optional[List[Tuple[int, int]]]:
    """(layer, head) pairs for ``name``, or None if unknown/shape-mismatched.

    A shape mismatch (e.g. a fine-tune reusing a standard name with different
    dims) returns None so the caller falls back to dynamic selection rather
    than aligning with the wrong heads.
    """
    blob = _ALIGNMENT_HEADS.get(name)
    if blob is None:
        return None
    mask = np.frombuffer(gzip.decompress(base64.b85decode(blob)), dtype=bool)
    if mask.size != n_text_layer * n_text_head:
        return None
    pairs = np.argwhere(mask.reshape(n_text_layer, n_text_head).copy())
    return [(int(l), int(h)) for l, h in pairs]


def resolve_model_name(name_or_path: str) -> Optional[str]:
    """Best-effort model name from a user string or checkpoint filename."""
    import os
    stem = os.path.basename(name_or_path)
    for suffix in ('.pt', '.safetensors'):
        if stem.endswith(suffix):
            stem = stem[:-len(suffix)]
    return stem if stem in _ALIGNMENT_HEADS else None
