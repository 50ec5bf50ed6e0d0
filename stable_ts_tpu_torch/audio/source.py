"""URL audio sources: yt-dlp piping and file:// resolution.

Behavioral counterpart of the reference's ``load_source``
(stable-ts stable_whisper/audio/utils.py:16-60): a string containing
``://`` is treated as a URL — ``file://`` resolves to a local path, anything
else is fetched through yt-dlp (best-audio stream piped to stdout) when
available, with a warning fallback that hands the URL to ffmpeg unchanged
(ffmpeg handles direct media links natively).
"""
import os
import shutil
import subprocess
import warnings
from typing import Optional, Union

__all__ = ['is_ytdlp_available', 'is_url', 'load_source']


def is_ytdlp_available() -> bool:
    return shutil.which('yt-dlp') is not None


def is_url(source) -> bool:
    return isinstance(source, str) and '://' in source


def _file_url_to_path(url: str) -> str:
    from urllib.parse import urlparse, unquote
    return unquote(urlparse(url).path)


def load_source(source: Union[str, bytes],
                verbose: Optional[bool] = False,
                only_ffmpeg: bool = False,
                return_dict: bool = False) -> Union[str, bytes, dict]:
    """Resolve ``source`` for decoding.

    - ``file://`` URL -> local path.
    - other URL + yt-dlp -> downloaded audio bytes (or, with
      ``return_dict=True``, a dict with the live ``popen``, title, duration,
      is_live — the reference's streaming handshake).
    - other URL without yt-dlp (or ``only_ffmpeg=True``) -> the URL itself,
      left for ffmpeg to fetch; a warning notes the reduced URL support.
    - anything else passes through untouched.
    """
    if not is_url(source):
        return source
    if source.startswith('file://'):
        path = _file_url_to_path(source)
        if return_dict:
            from .utils import get_metadata
            meta = get_metadata(path)
            return dict(popen=None, path=path,
                        title=os.path.basename(path),
                        duration=meta.get('duration'), is_live=False)
        return path
    if only_ffmpeg:
        return source
    if not is_ytdlp_available():
        warnings.warn(
            'URL detected but yt-dlp is not available. Only direct media '
            'links (handled by ffmpeg) will work; install yt-dlp for '
            'general URL support.')
        return source

    cmd = ['yt-dlp', source, '-f', 'ba/w', '-I', '1', '-o', '-']
    if return_dict:
        cmd += ['--no-simulate', '--print', 'title,duration,is_live',
                '--no-warnings']
        stderr = subprocess.PIPE
    else:
        stderr = None
        if verbose is None:
            cmd.append('-q')
        elif verbose:
            cmd.append('--progress')
        else:
            cmd += ['--progress', '-q']
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=stderr,
                            bufsize=0)
    if not return_dict:
        return proc.communicate()[0]

    # --print writes to stderr when stdout carries the media stream
    def next_line():
        return proc.stderr.readline().decode('utf-8', errors='ignore').strip('\n')

    title = next_line() or None
    try:
        duration = int(next_line())
    except ValueError:
        duration = None
    live_raw = next_line()
    is_live = {'True': True, 'False': False}.get(live_raw)
    if verbose is not None:
        print(f'Media Info (YT-DLP):\n'
              f'-Title: "{title or "N/A"}"\n'
              f'-Duration: {duration}s\n'
              f'-Live: {is_live}')
    return dict(popen=proc, title=title, duration=duration, is_live=is_live)
