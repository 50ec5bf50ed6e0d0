"""Subtitle / text serialization: SRT, VTT, ASS, TSV, TXT, JSON.

Behavioral counterpart of stable-ts stable_whisper/text_output.py with
the same byte-level output formats, including the word-level tag renderings:
SRT per-word highlight segments, VTT inline ``<ts>`` tags, and ASS ``{\\k}``
karaoke tags.
"""
import json
import os
import warnings
from itertools import chain
from typing import Callable, List, Optional, Tuple, Union

from .stabilization.utils import valid_ts

__all__ = ['result_to_srt_vtt', 'result_to_ass', 'result_to_tsv', 'result_to_txt',
           'save_as_json', 'load_result']

SUPPORTED_FORMATS = ('srt', 'vtt', 'ass', 'tsv', 'txt')


# -- time renderers ------------------------------------------------------------

def sec2hhmmss(seconds: Union[float, int]):
    mm, ss = divmod(seconds, 60)
    hh, mm = divmod(mm, 60)
    return hh, mm, ss


def sec2milliseconds(seconds: Union[float, int]) -> int:
    return round(seconds * 1000)


def sec2centiseconds(seconds: Union[float, int]) -> int:
    return round(seconds * 100)


def sec2vtt(seconds: Union[float, int]) -> str:
    hh, mm, ss = sec2hhmmss(seconds)
    return f'{hh:0>2.0f}:{mm:0>2.0f}:{ss:0>6.3f}'


def sec2srt(seconds: Union[float, int]) -> str:
    return sec2vtt(seconds).replace('.', ',')


def sec2ass(seconds: Union[float, int]) -> str:
    hh, mm, ss = sec2hhmmss(seconds)
    return f'{hh:0>1.0f}:{mm:0>2.0f}:{ss:0>2.2f}'


# -- block renderers ---------------------------------------------------------------

def finalize_text(text: str, strip: bool = True) -> str:
    if not strip:
        return text
    return text.strip().replace('\n ', '\n')


def segment2vttblock(segment: dict, strip: bool = True) -> str:
    return (f'{sec2vtt(segment["start"])} --> {sec2vtt(segment["end"])}\n'
            f'{finalize_text(segment["text"], strip)}')


def segment2srtblock(segment: dict, idx: int, strip: bool = True) -> str:
    return (f'{idx}\n{sec2srt(segment["start"])} --> {sec2srt(segment["end"])}\n'
            f'{finalize_text(segment["text"], strip)}')


def segment2assblock(segment: dict, idx: int, strip: bool = True) -> str:
    return (f'Dialogue: {idx},{sec2ass(segment["start"])},{sec2ass(segment["end"])},'
            f'Default,,0,0,0,,{finalize_text(segment["text"], strip)}')


def segment2tsvblock(segment: dict, strip: bool = True) -> str:
    text = segment['text'].strip() if strip else segment['text']
    return (f'{sec2milliseconds(segment["start"])}'
            f'\t{sec2milliseconds(segment["end"])}'
            f'\t{text}')


# -- word-level renderings ----------------------------------------------------------

def _word_timeline(words: List[dict]) -> List[Tuple[str, float, float]]:
    """Flatten a word list into contiguous (text, start, end) spans.

    Every word contributes one span; every nonzero gap between consecutive
    words contributes an empty-text span, so a highlight cycling through the
    timeline dwells on silences instead of jumping early to the next word.
    Times are rounded to ms so zero-length gaps introduced by float noise
    are dropped.
    """
    spans = []
    for i, word in enumerate(words):
        t0, t1 = round(word['start'], 3), round(word['end'], 3)
        spans.append((word['word'], t0, t1))
        if i + 1 < len(words):
            gap_end = round(words[i + 1]['start'], 3)
            if gap_end != t1:
                spans.append(('', t1, gap_end))
    return spans


def words2segments(words: List[dict], tag: Tuple[str, str],
                   reverse_text: bool = False) -> List[dict]:
    """One sub-segment per timeline span, with ``tag`` highlighting it.

    Each output cue carries the FULL segment text; only the tag placement
    differs between cues. The highlighted form of every span is precomputed
    once (``lit``) so emitting N cues is N joins, not N re-renders. A
    leading space is hoisted outside the opening tag; blank spans (gap
    fillers / whitespace-only words) are never tagged. ``reverse_text``
    reverses the display (join) order while cue times stay ascending.
    """
    spans = _word_timeline(words)
    plain = [text for text, _, _ in spans]
    lit = []
    for text in plain:
        if text in ('', ' '):
            lit.append(text)
        elif text.startswith(' '):
            lit.append(f' {tag[0]}{text[1:]}{tag[1]}')
        else:
            lit.append(f'{tag[0]}{text}{tag[1]}')

    order = list(range(len(spans)))
    if reverse_text:
        order.reverse()
    return [
        dict(text=''.join(lit[j] if j == i else plain[j] for j in order),
             start=spans[i][1], end=spans[i][2])
        for i in range(len(spans))
    ]


def to_word_level_segments(segments: List[dict], tag: Tuple[str, str]) -> List[dict]:
    return list(chain.from_iterable(
        words2segments(s['words'], tag, reverse_text=s.get('reversed_text'))
        for s in segments
    ))


def to_vtt_word_level_segments(segments: List[dict],
                               tag: Optional[Tuple[str, str]] = None) -> List[dict]:
    """VTT inline cue timestamps: ``word<00:00:01.000> next``.

    A single ``<t>`` marks a seamless word boundary; when the words do not
    touch, the pause is rendered as ``<end> <start>`` and the cue pair
    replaces one flanking space (trailing space of the text so far, else
    the next word's leading space) so playback highlighting stays aligned.
    """
    def render(segment: dict) -> str:
        out = ''
        prev_end = None
        for word in segment['words']:
            text = word['word']
            if prev_end is not None:
                start = word['start']
                if prev_end == start:
                    out += f'<{sec2vtt(start)}>'
                else:
                    if out.endswith(' '):
                        out = out[:-1]
                    elif text.startswith(' '):
                        text = text[1:]
                    out += f'<{sec2vtt(prev_end)}> <{sec2vtt(start)}>'
            out += text
            prev_end = word['end']
        return out

    return [dict(text=render(s), start=s['start'], end=s['end']) for s in segments]


def to_ass_word_level_segments(segments: List[dict], tag: Tuple[str, str],
                               karaoke: bool = False) -> List[dict]:
    r"""ASS ``{\k<centisec>}`` (or ``{\kf}`` for progressive fill) word timing tags.

    Each word becomes one fragment: optional space, the duration tag, then
    the word with its leading space (if any) hoisted before the tag.
    """
    marker = r'{\kf' if karaoke else r'{\k'

    def fragment(word: dict) -> str:
        text = word['word']
        lead = ' ' if text.startswith(' ') else ''
        cs = sec2centiseconds(word['end'] - word['start'])
        return f'{lead}{marker}{cs}}}{text[len(lead):]}'

    return [dict(text=''.join(fragment(w) for w in s['words']),
                 start=s['start'], end=s['end']) for s in segments]


def to_word_level(segments: List[dict]) -> List[dict]:
    return [dict(text=w['word'], start=w['start'], end=w['end'])
            for s in segments for w in s['words']]


# -- dispatch ------------------------------------------------------------------------

def _save_as_file(content: str, path: str):
    with open(path, 'w', encoding='utf-8') as f:
        f.write(content)
    print(f'Saved: {os.path.abspath(path)}')


def _get_segments(result, min_dur: float, reverse_text: Union[bool, tuple] = False):
    if isinstance(result, dict):
        if reverse_text:
            warnings.warn('``reverse_text=True`` only applies to WhisperResult '
                          f'but result is {type(result)}')
        return result.get('segments')
    if not isinstance(result, list) and callable(getattr(result, 'segments_to_dicts', None)):
        return result.apply_min_dur(min_dur, inplace=False).segments_to_dicts(
            reverse_text=reverse_text)
    return result


def _confirm_word_level(segments: List[dict]) -> bool:
    if not all(bool(s.get('words')) for s in segments):
        warnings.warn('Result is missing word timestamps. Word-level timing cannot be '
                      'exported. Use ``word_level=False`` to avoid this warning.')
        return False
    return True


def _resolve_target(filepath: Optional[str], filetype: Optional[str]):
    """Infer the format from the path (or default to srt), validate it, and
    make sure the save path carries the matching extension."""
    if filetype is None:
        filetype = os.path.splitext(filepath)[-1][1:] or 'srt'
    if filetype.lower() not in SUPPORTED_FORMATS:
        raise NotImplementedError(f'{filetype} not supported')
    if filepath and not filepath.lower().endswith(f'.{filetype}'):
        filepath = f'{filepath}.{filetype}'
    return filepath, filetype


def _expand_words(segments: List[dict], filetype: str, segment_level: bool,
                  tag, default_tag, renderer: Optional[Callable]) -> List[dict]:
    """Turn segment dicts into word-level cues.

    With ``segment_level`` the cues keep full segment text and a highlight
    tag (format default: SRT green <font>, otherwise underline); without it
    each word becomes its own bare cue.
    """
    if not segment_level:
        return to_word_level(segments)
    if tag is None:
        tag = default_tag or (('<font color="#00ff00">', '</font>')
                              if filetype == 'srt' else ('<u>', '</u>'))
    return (renderer or to_word_level_segments)(segments, tag)


def result_to_any(result,
                  filepath: Optional[str] = None,
                  filetype: Optional[str] = None,
                  segments2blocks: Optional[Callable] = None,
                  segment_level: bool = True,
                  word_level: bool = True,
                  min_dur: float = 0.02,
                  tag: Optional[Tuple[str, str]] = None,
                  default_tag: Optional[Tuple[str, str]] = None,
                  strip: bool = True,
                  reverse_text: Union[bool, tuple] = False,
                  to_word_level_string_callback: Optional[Callable] = None):
    """Render ``result`` to a subtitle/text format; save if ``filepath`` given."""
    assert segment_level or word_level, '`segment_level` or `word_level` must be True'
    segments = _get_segments(result, min_dur, reverse_text=reverse_text)
    word_level = word_level and _confirm_word_level(segments)
    filepath, filetype = _resolve_target(filepath, filetype)

    if word_level:
        segments = _expand_words(segments, filetype, segment_level, tag,
                                 default_tag, to_word_level_string_callback)
    if not valid_ts(segments, warn=False):
        warnings.warn('Result contains out of order timestamp(s). '
                      'Output file may not playback properly.')

    if segments2blocks is not None:
        sub_str = segments2blocks(segments)
    else:
        sub_str = '\n\n'.join(segment2srtblock(s, i, strip=strip)
                              for i, s in enumerate(segments, 1))

    if filepath:
        _save_as_file(sub_str, filepath)
        return None
    return sub_str


def result_to_srt_vtt(result, filepath: Optional[str] = None,
                      segment_level: bool = True, word_level: bool = True,
                      min_dur: float = 0.02,
                      tag: Optional[Tuple[str, str]] = None,
                      vtt: Optional[bool] = None, strip: bool = True,
                      reverse_text: Union[bool, tuple] = False):
    """Generate SRT/VTT subtitles with optional word-level highlighting."""
    if vtt is None:
        vtt = bool(filepath) and filepath.lower().endswith('.vtt')
    blocks = word_cb = None
    if vtt:
        def blocks(segments):
            return 'WEBVTT\n\n' + '\n\n'.join(
                segment2vttblock(s, strip=strip) for s in segments)
        if tag is None:
            word_cb = to_vtt_word_level_segments

    return result_to_any(result, filepath, 'vtt' if vtt else 'srt', blocks,
                         segment_level=segment_level, word_level=word_level,
                         min_dur=min_dur, tag=tag, strip=strip,
                         reverse_text=reverse_text,
                         to_word_level_string_callback=word_cb)


def result_to_tsv(result, filepath: Optional[str] = None,
                  segment_level: Optional[bool] = None,
                  word_level: Optional[bool] = None, min_dur: float = 0.02,
                  strip: bool = True,
                  reverse_text: Union[bool, tuple] = False):
    """Generate TSV (start-ms, end-ms, text) lines."""
    if segment_level is None and word_level is None:
        segment_level = True
    assert word_level is not segment_level, \
        '[word_level] and [segment_level] cannot be the same since [tag] is not supported'

    return result_to_any(
        result, filepath, 'tsv',
        lambda segments: '\n\n'.join(segment2tsvblock(s, strip=strip)
                                     for s in segments),
        segment_level=segment_level, word_level=word_level, min_dur=min_dur,
        strip=strip, reverse_text=reverse_text)


_ASS_DEFAULT_STYLE = {
    'Name': 'Default', 'Fontname': 'Arial', 'Fontsize': '48',
    'PrimaryColour': '&Hffffff', 'SecondaryColour': '&Hffffff',
    'OutlineColour': '&H0', 'BackColour': '&H0', 'Bold': '0', 'Italic': '0',
    'Underline': '0', 'StrikeOut': '0', 'ScaleX': '100', 'ScaleY': '100',
    'Spacing': '0', 'Angle': '0', 'BorderStyle': '1', 'Outline': '1',
    'Shadow': '0', 'Alignment': '2', 'MarginL': '10', 'MarginR': '10',
    'MarginV': '10', 'Encoding': '0',
}


def _ass_style_header(style_overrides: dict, tag, highlight_color: str,
                      font: Optional[str], font_size) -> str:
    """Script-info + style preamble for an ASS document."""
    style = dict(_ASS_DEFAULT_STYLE)
    for k, v in style_overrides.items():
        if 'colour' in k.lower() and not str(v).startswith('&H'):
            v = f'&H{v}'
        if k in style:
            style[k] = v
    if tag is None and 'PrimaryColour' not in style_overrides:
        style['PrimaryColour'] = (highlight_color if highlight_color.startswith('&H')
                                  else f'&H{highlight_color}')
    if font:
        style['Fontname'] = font
    if font_size:
        style['Fontsize'] = font_size

    return ('[Script Info]\nScriptType: v4.00+\nPlayResX: 384\nPlayResY: 288\n'
            'ScaledBorderAndShadow: yes\n\n'
            f'[V4+ Styles]\nFormat: {", ".join(map(str, style.keys()))}\n'
            f'Style: {",".join(map(str, style.values()))}\n\n'
            '[Events]\nFormat: Layer, Start, End, Style, Name, MarginL, MarginR, '
            'MarginV, Effect, Text\n\n')


def result_to_ass(result, filepath: Optional[str] = None,
                  segment_level: bool = True, word_level: bool = True,
                  min_dur: float = 0.02,
                  tag: Union[Tuple[str, str], int, None] = None,
                  font: Optional[str] = None, font_size: int = 24,
                  strip: bool = True, highlight_color: Optional[str] = None,
                  karaoke: bool = False,
                  reverse_text: Union[bool, tuple] = False, **kwargs):
    """Generate an Advanced SubStation Alpha (ASS) subtitle file."""
    if tag == ['-1']:  # CLI passes tags as string lists
        tag = -1
    highlight_color = highlight_color or '00ff00'

    def blocks(segments):
        return (_ass_style_header(kwargs, tag, highlight_color, font, font_size)
                + '\n'.join(segment2assblock(s, i, strip=strip)
                            for i, s in enumerate(segments)))

    if tag is not None and karaoke:
        warnings.warn('``tag`` is not supported for ``karaoke=True``; it will be ignored.')

    word_cb = None
    if karaoke or (word_level and segment_level and tag is None):
        def word_cb(segments, tag_pair):
            return to_ass_word_level_segments(segments, tag_pair, karaoke=karaoke)

    return result_to_any(result, filepath, 'ass', blocks,
                         segment_level=segment_level, word_level=word_level,
                         min_dur=min_dur, tag=None if tag == -1 else tag,
                         default_tag=(r'{\1c' + f'{highlight_color}&' + '}', r'{\r}'),
                         strip=strip, reverse_text=reverse_text,
                         to_word_level_string_callback=word_cb)


def result_to_txt(result, filepath: Optional[str] = None,
                  min_dur: float = 0.02, strip: bool = True,
                  reverse_text: Union[bool, tuple] = False):
    """Generate plain text (one segment per line, no timestamps)."""
    return result_to_any(
        result, filepath, 'txt',
        lambda segments: '\n'.join(s['text'].strip() if strip else s['text']
                                   for s in segments),
        segment_level=True, word_level=False, min_dur=min_dur, strip=strip,
        reverse_text=reverse_text)


def save_as_json(result, path: str, ensure_ascii: bool = False, **kwargs):
    """Serialize ``result`` (dict or WhisperResult) to a JSON file."""
    if not isinstance(result, dict) and callable(getattr(result, 'to_dict')):
        result = result.to_dict()
    if not path.lower().endswith('.json'):
        path += '.json'
    _save_as_file(json.dumps(result, allow_nan=True, ensure_ascii=ensure_ascii, **kwargs),
                  path)


def load_result(json_path: str) -> dict:
    """Load a result dict previously saved with :func:`save_as_json`."""
    with open(json_path, 'r', encoding='utf-8') as f:
        return json.load(f)
