"""Shared helpers for the result data model."""
from typing import Callable, List, Optional, Union


def round_timestamp(ts: Optional[float]) -> Optional[float]:
    """Round to 3 decimals (20 ms token grid fits in 3 dp); passes through 0/None."""
    if not ts:
        return ts
    return round(ts, 3)


def combine_attr(target, other, attr: str):
    """Merge ``other``'s attribute into ``target`` in place.

    Lists are concatenated (None on either side poisons to None for lists on
    the other side); scalars are averaged; a None partner yields None.
    Matches reference semantics (result.py:23-33) used when merging
    words/segments so quality metrics stay meaningful.
    """
    val = getattr(target, attr)
    if val is None:
        return
    other_val = getattr(other, attr)
    if isinstance(val, list):
        if other_val is None:
            setattr(target, attr, None)
        else:
            val.extend(other_val)
    else:
        setattr(target, attr, None if other_val is None else (val + other_val) / 2)


class ContentCache:
    """Store non-serializable regroup-history arguments (callables, objects).

    The regroup history is a plain string; when an operation receives an
    object argument (e.g. a filter function), we stash it under a ``<repr>``
    key so replaying the history within the same session resolves it back
    (reference result.py:47-71).
    """

    def __init__(self):
        self._items = {}

    def store(self, content: Union[Callable, object]) -> str:
        if content is None:
            return ''
        if isinstance(content, str):
            return content
        key = repr(content).replace('_', '-')
        if not key.startswith('<') and not key.endswith('>'):
            key = f'<{key}>'
        self._items[key] = content
        return key

    def resolve(self, content, strict: bool = True):
        if isinstance(content, str) and content.startswith('<') and content.endswith('>'):
            found = {'<True>': True, '<False>': False}.get(content)
            if found is None:
                found = self._items.get(content)
            if found is None:
                if strict:
                    raise NameError(f'{content.replace("-", "_")} not found')
                return content
            return found
        return content


def group_words_by_lock(words: list, only_text: bool = False,
                        include_single: bool = False) -> List[list]:
    """Partition ``words`` into runs joined by lock flags.

    Consecutive words belong to the same run when the left word is
    right-locked or the right word is left-locked.
    """
    groups: List[list] = []
    for word in words:
        if groups and (groups[-1][-1].right_locked or word.left_locked):
            groups[-1].append(word)
        else:
            groups.append([word])
    if only_text:
        groups = [[w.word for w in ws] for ws in groups]
    if not include_single:
        groups = [ws for ws in groups if len(ws) > 1]
    return groups
