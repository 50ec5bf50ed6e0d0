"""Result data model: words, segments, results, regrouping, and search."""
from .word import WordTiming
from .segment import Segment
from .whisper_result import WhisperResult, DEFAULT_REGROUP_ALGO
from .find import SegmentMatch, WhisperResultMatches

__all__ = ['WordTiming', 'Segment', 'WhisperResult', 'DEFAULT_REGROUP_ALGO',
           'SegmentMatch', 'WhisperResultMatches']
