"""Subtitle comparison video (counterpart of reference video_output.py).

Requires an ffmpeg binary on PATH (the only feature that does): stacks N
subtitle tracks over the video/audio for visual comparison of timing
algorithms. Gated with a clear error when ffmpeg is unavailable.
"""
import shutil
import subprocess
from typing import List

__all__ = ['encode_video_comparison']


def encode_video_comparison(
        audiofile: str,
        subtitle_files: List[str],
        output_videopath: str = None,
        *,
        labels: List[str] = None,
        height: int = 90,
        width: int = 720,
        color: str = 'black',
        fontsize: int = 70,
        border_color: str = 'white',
        label_color: str = 'white',
        label_size: int = 14,
        fps: int = 25,
        video_codec: str = None,
        audio_codec: str = None,
        overwrite: bool = False,
) -> str:
    """Render ``audiofile`` with stacked subtitle tracks into one video."""
    if shutil.which('ffmpeg') is None:
        raise RuntimeError('encode_video_comparison requires an ffmpeg binary '
                           'on PATH; none was found.')
    vc = f':v c={color}:s={width}x{height * len(subtitle_files)}'
    background = f'color={vc}:r={fps}[base]'
    border = f':border={border_color}' if border_color else ''
    subtitle_filter = []
    label_filter = []
    for i, sub in enumerate(subtitle_files):
        idx = i + 1
        sub_escaped = sub.replace("'", r"\'")
        subtitle_filter.append(
            f"[{i}]subtitles='{sub_escaped}':force_style="
            f"'Fontsize={fontsize}{border}'[sub{idx}]")
        if labels:
            label = labels[i] if i < len(labels) else sub
            label_filter.append(
                f"[sub{idx}]drawtext=text='{label}':fontcolor={label_color}"
                f":fontsize={label_size}:x=10:y=10[lsub{idx}]")
    tag = 'lsub' if labels else 'sub'
    stack_inputs = ''.join(f'[{tag}{i + 1}]' for i in range(len(subtitle_files)))
    stack = f'{stack_inputs}vstack=inputs={len(subtitle_files)}[v]'
    filters = ';'.join([background] + subtitle_filter + label_filter + [stack])

    if output_videopath is None:
        output_videopath = audiofile.rsplit('.', 1)[0] + '_compare.mp4'
    cmd = ['ffmpeg']
    if overwrite:
        cmd.append('-y')
    for _ in subtitle_files:
        cmd += ['-f', 'lavfi', '-i', f'color={vc}:r={fps}']
    cmd += ['-i', audiofile, '-filter_complex', filters,
            '-map', '[v]', '-map', f'{len(subtitle_files)}:a']
    if video_codec:
        cmd += ['-c:v', video_codec]
    if audio_codec:
        cmd += ['-c:a', audio_codec]
    cmd.append(output_videopath)
    subprocess.run(cmd, check=True)
    return output_videopath
