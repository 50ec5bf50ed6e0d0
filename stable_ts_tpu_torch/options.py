"""Option grouping: sort loose kwargs into typed option groups.

Behavioral counterpart of stable-ts stable_whisper/options.py:
``AllOptions`` consumes a flat dict of keyword arguments, distributes them
into progress / preprocessing / silence / postprocessing / alignment groups,
and raises ``TypeError`` on anything left unclaimed. Each group can also
arrive pre-built under its ``*_options`` key.

Design notes (TPU build): groups are declared as a ``SCHEMA`` mapping of
field name -> default on a single generic base class, instead of per-class
``__init__`` bodies. Adding an option is a one-line schema edit.
"""
import warnings
from typing import Callable, List, Optional, Union


class OptionGroup:
    """Generic kwargs sponge driven by a class-level ``SCHEMA``.

    Construction claims every SCHEMA field it finds in ``kwargs`` and keeps
    the remainder in ``_kwargs`` for the next group (or for rejection).
    ``KEY`` names the kwarg under which a caller may hand in a pre-built
    instance of this group, which is then adopted wholesale.
    """

    SCHEMA: dict = {}
    KEY: str = ''

    def __init__(self, **kwargs):
        self._kwargs = kwargs
        if self.KEY and self._adopt(kwargs.pop(self.KEY, None) if self.KEY in kwargs else None):
            return
        for field, default in self.SCHEMA.items():
            setattr(self, field, kwargs.pop(field, default))

    def _adopt(self, prebuilt) -> bool:
        if prebuilt is None:
            return False
        if not isinstance(prebuilt, self.__class__):
            raise TypeError(
                f'expected "{self.KEY}" to be {self.__class__} but got {type(prebuilt)}')
        vars(self).update(vars(prebuilt))
        return True

    def pop(self):
        """Return (self, unclaimed kwargs) and clear the internal remainder."""
        leftover, self._kwargs = self._kwargs, {}
        return self, leftover

    def raise_extras(self):
        if self._kwargs:
            unknown = ', '.join(self._kwargs)
            raise TypeError(f'got unexpected keyword argument(s): {unknown}')

    raise_extra = raise_extras  # reference-API alias

    def dict(self) -> dict:
        return {k: v for k, v in vars(self).items() if k != '_kwargs'}

    def update(self, options: dict):
        """Absorb matching keys from ``options`` in place, removing them."""
        for field in [k for k in options if hasattr(self, k)]:
            setattr(self, field, options.pop(field))


# Alias kept for callers that subclass the reference's base name.
BasicOptions = OptionGroup


class ProgressOptions(OptionGroup):
    KEY = 'progress_options'
    SCHEMA = dict(verbose=False, progress_callback=None)


class PreprocessingOptions(OptionGroup):
    KEY = 'preprocessing_options'
    SCHEMA = dict(denoiser=None, denoiser_options=None,
                  only_voice_freq=False, stream=None)


class SilenceOptions(OptionGroup):
    KEY = 'silence_options'
    SCHEMA = dict(q_levels=20, k_size=5, vad=False, vad_threshold=0.35)


class PostprocessingOptions(OptionGroup):
    KEY = 'postprocessing_options'
    SCHEMA = dict(regroup=True, suppress_silence=True, suppress_word_ts=True,
                  use_word_position=True, min_word_dur=None,
                  min_silence_dur=None, nonspeech_error=0.1,
                  prepend_punctuations=None, append_punctuations=None)


class AlignmentOptions(OptionGroup):
    KEY = 'alignment_options'
    SCHEMA = dict(split_callback=None, gap_padding=' ...', presplit=True,
                  extra_models=None, dynamic_heads=None, aligner='legacy')

    def to_non_vanilla(self):
        for field in ('extra_models', 'dynamic_heads'):
            if getattr(self, field):
                warnings.warn(f'``{field}`` is only supported for native Whisper models')


class AllOptions(OptionGroup):
    """Distribute a loose kwargs dict across every option group.

    Group classes are tried in declaration order; each claims its schema
    fields from the shared remainder, and whatever survives every group is
    an unknown kwarg -> TypeError.
    """

    KEY = 'all_options'
    GROUPS = (('progress', ProgressOptions), ('pre', PreprocessingOptions),
              ('post', PostprocessingOptions), ('silence', SilenceOptions),
              ('align', AlignmentOptions))

    def __init__(self, options: dict, progress: bool = True, pre: bool = True,
                 post: bool = True, silence: bool = True, align: bool = True,
                 vanilla_align: bool = False):
        self._kwargs = dict(options)
        if self.KEY in self._kwargs and self._adopt(self._kwargs.pop(self.KEY)):
            return
        enabled = dict(progress=progress, pre=pre, post=post,
                       silence=silence, align=align)
        for attr, group_cls in self.GROUPS:
            setattr(self, attr,
                    self._claim(group_cls) if enabled[attr] else None)
        if self.align is not None and not vanilla_align:
            self.align.to_non_vanilla()
        self.raise_extras()

    def _claim(self, group_cls):
        """Build one group from the shared kwargs remainder.

        A pre-built instance under the group's own key is adopted directly;
        otherwise the group claims its fields and returns the rest to us.
        """
        if group_cls.KEY in self._kwargs:
            group = group_cls(**{group_cls.KEY: self._kwargs.pop(group_cls.KEY)})
            group.raise_extras()
            return group
        group, self._kwargs = group_cls(**self._kwargs).pop()
        return group

    def dict(self) -> dict:
        return {cls.KEY: getattr(self, attr) for attr, cls in self.GROUPS}

    def update(self, options: dict):
        if not options:
            return
        for attr, _cls in self.GROUPS:
            group = getattr(self, attr)
            if group is not None:
                group.update(options)
        self._kwargs = options
        self.raise_extras()
