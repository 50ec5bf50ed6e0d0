"""Global mutable defaults and cached plugin instances.

TPU-native counterpart of the reference's global-default mechanism
(see stable-ts stable_whisper/default.py:4-23): a small mutable
mapping of cross-cutting defaults (punctuation sets, minimum word
duration) plus a cache for lazily-loaded plugin models (denoisers, VADs).
"""
import os
from typing import Optional, Union

DEFAULTS = dict(
    prepend_punctuations="\"'“¿([{-「",
    append_punctuations="\"'.。,，!！?？:：”)]}、」",
    min_word_dur=0.1,
)

# Lazily populated caches for optional plugin models keyed by plugin name.
cached_model_instances = dict(
    silero_vad={True: None, False: None},
    denoisers={},
)

_permissions = {}

__all__ = [
    'DEFAULTS',
    'cached_model_instances',
    'get_prepend_punctuations',
    'get_append_punctuations',
    'get_min_word_dur',
    'set_default',
    'is_allow_overwrite',
    'set_global_overwrite_permission',
]


def set_default(key: str, value):
    if key not in DEFAULTS:
        raise KeyError(f'unknown default key: {key!r}; valid keys: {tuple(DEFAULTS)}')
    DEFAULTS[key] = value


def _get(key: str, override):
    if override is not None:
        return override
    return DEFAULTS[key]


def get_prepend_punctuations(override: Optional[str] = None) -> str:
    return _get('prepend_punctuations', override)


def get_append_punctuations(override: Optional[str] = None) -> str:
    return _get('append_punctuations', override)


def get_min_word_dur(override: Optional[float] = None) -> float:
    return _get('min_word_dur', override)


def is_allow_overwrite(filepath: str, default: Union[bool, None] = None) -> bool:
    """Interactive overwrite guard (reference: default.py:71-80)."""
    if default is not None:
        return default
    if not os.path.isfile(filepath) or _permissions.get('overwrite'):
        return True
    while True:
        resp = input(f'"{filepath}" already exists, overwrite (y/n)? ').lower()
        if resp in ('y', 'n'):
            return resp == 'y'
        print(f'Expected "y" or "n", but got {resp}.')


def set_global_overwrite_permission(overwrite: bool):
    _permissions['overwrite'] = overwrite
