"""Command-line interface of the port (port of stable_ts_tpu/cli.py).

Counterpart of stable-ts stable_whisper/whisper_word_level/cli.py:
multi-input/multi-output mapping, JSON-input reprocessing, align / refine /
locate modes, regroup control, all subtitle output formats, model caching
with a ``--persist`` REPL, unfinished-result saving, and ``--debug`` call
echoing. The flags, defaults and help are stable_ts_tpu's, but for the
device: ``--device`` takes ``cuda`` (the default) or ``cpu`` and goes to
``load_model(device=...)``; ``--dtype`` / ``--fp16`` give torch dtypes;
there is no compilation cache to switch on. ``--shard`` (with ``--tp``)
runs under ``torchrun``, one process per GPU: each rank joins the world
from torchrun's environment (NCCL on the GPU, gloo with ``--device
cpu``), shards the loaded model over the (dp, tp) mesh and computes the
same result; rank 0 alone writes the output files.

Usage:
    stable-ts-tpu-torch audio.wav -o out.srt
    stable-ts-tpu-torch audio.flac --align text.txt --language en -o out.json
    python -m stable_ts_tpu_torch audio.wav --output_format srt,json
    stable-ts-tpu-torch audio.wav --device cpu     # no GPU: f32 on the CPU
    torchrun --nproc_per_node 2 -m stable_ts_tpu_torch audio.wav --shard --tp 2
"""
import argparse
import json
import os
import shlex
import sys
import warnings
from os.path import basename, isfile, join, splitext
from typing import Callable, Dict, List, Optional, Union

from ._version import __version__
from .defaults import (get_append_punctuations, get_prepend_punctuations,
                       is_allow_overwrite, set_global_overwrite_permission)
from .result import WhisperResult
from .utils import isolate_useful_options, str_to_valid_type

OUTPUT_FORMATS_METHODS = {
    'srt': 'to_srt_vtt',
    'vtt': 'to_srt_vtt',
    'ass': 'to_ass',
    'tsv': 'to_tsv',
    'txt': 'to_txt',
    'json': 'save_as_json',
}
OUTPUT_FORMATS = set(OUTPUT_FORMATS_METHODS)


def _str2bool(string: str) -> bool:
    table = {'true': True, 'false': False, '1': True, '0': False}
    string = string.lower()
    if string in table:
        return table[string]
    raise ValueError(f'Expected one of {set(table)}, got {string}')


def _optional_float(string):
    return None if string.lower() == 'none' else float(string)


def _optional_int(string):
    return None if string.lower() == 'none' else int(string)


def _parse_extra_options(pairs: Optional[List[str]]) -> dict:
    """Parse repeated ``key=value`` escape-hatch options."""
    out = {}
    for pair in pairs or []:
        if '=' not in pair:
            raise ValueError(f'expected key=value but got {pair!r}')
        key, value = pair.split('=', 1)
        out[key.strip()] = str_to_valid_type(value.strip())
    return out


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog='stable-ts-tpu-torch',
        description='Stabilized word-level Whisper timestamps on a CUDA GPU.',
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    parser.add_argument('inputs', nargs='+',
                        help='audio/video file(s) to transcribe or JSON result '
                             'file(s) to reprocess')
    parser.add_argument('--output', '-o', action='extend', nargs='+', type=str,
                        help='output path(s); uses the input basename otherwise')
    parser.add_argument('--model', '-m', default='base',
                        help='name or path of the Whisper checkpoint')
    parser.add_argument('--model_dir', default=None,
                        help='directory containing model checkpoints')
    parser.add_argument('--vocab', default=None,
                        help='path to tokenizer vocabulary '
                             '(tiktoken ranks or HF vocab.json)')
    parser.add_argument('--output_dir', '-d', default=None,
                        help='directory to save outputs in')
    parser.add_argument('--output_format', '-f', default=None,
                        help='format(s) of the output file(s); '
                             f'comma-separated subset of {sorted(OUTPUT_FORMATS)}')
    parser.add_argument('--verbose', '-v', type=int, default=1, choices=(0, 1, 2),
                        help='0: no progress; 1: progress; 2: all details')
    parser.add_argument('--task', default='transcribe',
                        choices=('transcribe', 'translate'))
    parser.add_argument('--language', '-l', default=None)
    parser.add_argument('--dtype', default=None, choices=(None, 'float32', 'bfloat16'),
                        help='parameter dtype on device')
    parser.add_argument('--dynamic_quantization', '-dq', action='store_true',
                        help='int8 weight-only quantization of the linear '
                             'projections (halves weight HBM traffic); '
                             'STABLE_TS_TPU_WOQ=dyn quantizes the '
                             'activations too (int8 x int8)')
    parser.add_argument('--shard', action='store_true',
                        help='place the model on a (dp, tp) mesh over all '
                             'visible devices; not ported yet (raises)')
    parser.add_argument('--tp', type=_optional_int, default=None,
                        help='tensor-parallel width for --shard '
                             '(default: auto)')

    # task modes
    parser.add_argument('--align', '-a', default=None,
                        help='path to plain text/JSON to align with the audio, '
                             'or "text:<the text itself>"')
    parser.add_argument('--align_words', default=None,
                        help='path to JSON result; realign its words within '
                             'each segment span')
    parser.add_argument('--locate', default=None,
                        help='word/phrase to locate in the audio')
    parser.add_argument('--refine', '-r', action='store_true',
                        help='refine timestamps of the result')
    parser.add_argument('--transcribe_method', default='transcribe',
                        choices=('transcribe', 'transcribe_minimal', 'transcribe_batched'))
    parser.add_argument('--batch_size', type=int, default=8,
                        help='30-s windows decoded per device batch '
                             '(transcribe_batched only)')

    # decoding
    parser.add_argument('--temperature', type=float, default=0)
    parser.add_argument('--best_of', type=_optional_int, default=None)
    parser.add_argument('--beam_size', type=_optional_int, default=None)
    parser.add_argument('--patience', type=_optional_float, default=None)
    parser.add_argument('--length_penalty', type=_optional_float, default=None)
    parser.add_argument('--suppress_tokens', type=str, default='-1')
    parser.add_argument('--initial_prompt', type=str, default=None)
    parser.add_argument('--condition_on_previous_text', type=_str2bool, default=True)
    parser.add_argument('--temperature_increment_on_fallback', type=_optional_float,
                        default=0.2)
    parser.add_argument('--compression_ratio_threshold', type=_optional_float,
                        default=2.4)
    parser.add_argument('--logprob_threshold', type=_optional_float, default=-1.0)
    parser.add_argument('--no_speech_threshold', type=_optional_float, default=0.6)

    # stabilization
    parser.add_argument('--word_timestamps', type=_str2bool, default=True)
    parser.add_argument('--regroup', type=str, default='True',
                        help='regroup algorithm string, or True/False')
    parser.add_argument('--suppress_silence', type=_str2bool, default=True)
    parser.add_argument('--suppress_word_ts', type=_str2bool, default=True)
    parser.add_argument('--suppress_ts_tokens', type=_str2bool, default=False)
    parser.add_argument('--use_word_position', type=_str2bool, default=True)
    parser.add_argument('--vad', type=_str2bool, default=False)
    parser.add_argument('--vad_threshold', type=float, default=0.35)
    parser.add_argument('--q_levels', type=int, default=20)
    parser.add_argument('--k_size', type=int, default=5)
    parser.add_argument('--min_word_dur', type=_optional_float, default=None)
    parser.add_argument('--min_silence_dur', type=_optional_float, default=None)
    parser.add_argument('--nonspeech_error', type=float, default=0.1)
    parser.add_argument('--gap_padding', type=str, default=' ...')
    parser.add_argument('--max_instant_words', type=float, default=0.5)
    parser.add_argument('--avg_prob_threshold', type=_optional_float, default=None)
    parser.add_argument('--nonspeech_skip', type=_optional_float, default=None)
    parser.add_argument('--prepend_punctuations', '-pp', type=str,
                        default=get_prepend_punctuations())
    parser.add_argument('--append_punctuations', '-ap', type=str,
                        default=get_append_punctuations())
    parser.add_argument('--denoiser', type=str, default=None)
    parser.add_argument('--only_voice_freq', '-ovf', action='store_true')
    parser.add_argument('--dynamic_heads', type=str, default=None)
    parser.add_argument('--aligner', type=str, default='legacy')
    parser.add_argument('--clip_timestamps', type=str, default=None)
    parser.add_argument('--resume', '--resume_input', '-ri', type=str, default=None,
                        help='path of unfinished JSON result to resume from')
    parser.add_argument('--save_unfinished', '-su', action='store_true',
                        help='save an -UNFINISHED.json when transcription is '
                             'interrupted (implied by --resume)')
    parser.add_argument('--delete_resume', '-dr', action='store_true',
                        help='delete the --resume file once transcription '
                             'finishes successfully')

    # output rendering
    parser.add_argument('--segment_level', type=_str2bool, default=True)
    parser.add_argument('--word_level', type=_str2bool, default=True)
    parser.add_argument('--min_dur', type=float, default=0.02)
    parser.add_argument('--tag', type=str, action='extend', nargs='+', default=None)
    parser.add_argument('--font', type=str, default='Arial')
    parser.add_argument('--font_size', type=int, default=48)
    parser.add_argument('--karaoke', type=_str2bool, default=False)
    parser.add_argument('--strip', type=_str2bool, default=True)
    parser.add_argument('--max_chars', type=_optional_int, default=None,
                        help='split segments longer than this many characters')
    parser.add_argument('--max_words', type=_optional_int, default=None,
                        help='split segments longer than this many words')

    # escape hatches
    parser.add_argument('--model_option', action='extend', nargs='+', type=str)
    parser.add_argument('--transcribe_option', action='extend', nargs='+', type=str)
    parser.add_argument('--refine_option', action='extend', nargs='+', type=str)
    parser.add_argument('--locate_option', action='extend', nargs='+', type=str)
    parser.add_argument('--save_option', action='extend', nargs='+', type=str)

    # reference-CLI compatibility surface (accepted everywhere; flags that
    # have no equivalent here warn instead of erroring)
    parser.add_argument('--device', default=None,
                        help="compute device ('cuda' or 'cpu'); default cuda")
    parser.add_argument('--fp16', type=_str2bool, default=None,
                        help='half-precision parameters (mapped to bfloat16)')
    parser.add_argument('--cpu_preload', type=_str2bool, default=True,
                        help='accepted for compatibility; checkpoints are '
                             'always read on the host before the transfer')
    parser.add_argument('--threads', type=_optional_int, default=None,
                        help='accepted for compatibility')
    parser.add_argument('--demucs', type=_str2bool, default=False,
                        help='deprecated alias for --denoiser demucs')
    parser.add_argument('--demucs_option', action='extend', nargs='+', type=str,
                        help='deprecated alias for --denoiser_option')
    parser.add_argument('--denoiser_option', action='extend', nargs='+', type=str,
                        help='k=v option(s) for the denoiser')
    parser.add_argument('--denoiser_output', '--demucs_output', type=str,
                        default=None, help='path to save the denoised audio')
    parser.add_argument('--only_ffmpeg', action='store_true',
                        help='use ffmpeg for audio decode even for WAV/FLAC '
                             '(skips the native decoder)')
    parser.add_argument('--mel_first', action='store_true',
                        help='process the full audio into mel features before '
                             'decoding (higher memory, fewer host syncs)')
    parser.add_argument('--no_stream', action='store_true',
                        help='load the full audio into memory instead of '
                             'streaming chunks')
    parser.add_argument('--reverse_text', type=_str2bool, default=False,
                        help='reverse word order per segment for RTL players')
    parser.add_argument('--vad_onnx', type=_str2bool, default=False,
                        help='accepted for compatibility (Silero ONNX is not '
                             'used; VAD backends: energy/nonvad/silero)')
    parser.add_argument('--time_scale', type=_optional_float, default=None,
                        help='deprecated (accepted for compatibility)')
    parser.add_argument('--ts_num', type=_optional_int, default=None,
                        help='deprecated (accepted for compatibility)')
    parser.add_argument('--ts_noise', type=_optional_float, default=None,
                        help='deprecated (accepted for compatibility)')
    parser.add_argument('--faster_whisper', '-fw', action='store_true',
                        help='not available from the command line; load a '
                             'faster-whisper model in Python with '
                             'load_faster_whisper instead')
    parser.add_argument('--huggingface_whisper', '-hw', action='store_true',
                        help='load the model as an HF Whisper directory')
    parser.add_argument('--mlx_whisper', '-mlx', action='store_true',
                        help='not available in this framework (Apple-only)')

    parser.add_argument('--overwrite', '-y', action='store_true',
                        help='overwrite outputs without prompting')
    parser.add_argument('--debug', action='store_true',
                        help='print the arguments of each method call')
    parser.add_argument('--persist', '-p', action='store_true',
                        help='keep the model loaded; read commands from stdin')
    parser.add_argument('--version', action='version',
                        version=f'stable-ts-tpu-torch {__version__}')
    return parser


def _finalize_outputs(inputs: List[str], outputs: Optional[List[str]],
                      output_dir: Optional[str],
                      output_formats: Optional[List[str]]) -> List[List[str]]:
    """Map every input to its list of output paths."""
    if outputs:
        if len(outputs) != len(inputs):
            raise ValueError(f'got {len(inputs)} input(s) but '
                             f'{len(outputs)} output(s)')
        final = [[o] for o in outputs]
        if output_formats:
            final = [
                [splitext(o)[0] + '.' + fmt for fmt in output_formats]
                for o in outputs
            ]
        return final
    formats = output_formats or ['srt']
    final = []
    for inp in inputs:
        stem = splitext(basename(inp))[0]
        if output_dir:
            stem = join(output_dir, stem)
        else:
            stem = join(os.path.dirname(inp) or '.', stem)
        final.append([f'{stem}.{fmt}' for fmt in formats])
    return final


def _call(method: Callable, args_dict: dict, debug: bool):
    if debug:
        printable = {k: (f'<{type(v).__name__}>'
                         if hasattr(v, '__len__') and not isinstance(v, str)
                         and len(str(v)) > 200 else v)
                     for k, v in args_dict.items()}
        print(f'{method.__name__}({", ".join(f"{k}={v!r}" for k, v in printable.items())})')
    return method(**args_dict)


def _save_result(result: WhisperResult, path: str, args, save_options: dict,
                 debug: bool):
    fmt = splitext(path)[1][1:].lower() or 'srt'
    if fmt not in OUTPUT_FORMATS:
        raise NotImplementedError(f'unsupported output format: {fmt}')
    if not is_allow_overwrite(path, True if args.overwrite else None):
        return
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    method = getattr(result, OUTPUT_FORMATS_METHODS[fmt])
    kwargs = dict(save_options)
    if fmt in ('srt', 'vtt'):
        kwargs.update(isolate_useful_options(vars(args), result.to_srt_vtt))
        kwargs.update(filepath=path, vtt=fmt == 'vtt')
        kwargs.pop('inputs', None)
    elif fmt == 'ass':
        kwargs.update(isolate_useful_options(vars(args), result.to_ass))
        kwargs.update(filepath=path, font=args.font, font_size=args.font_size,
                      karaoke=args.karaoke)
    elif fmt == 'tsv':
        kwargs.update(filepath=path, segment_level=True, word_level=False,
                      strip=args.strip)
    elif fmt == 'txt':
        kwargs.update(filepath=path, strip=args.strip)
    else:  # json
        kwargs.update(path=path)
    if 'tag' in kwargs and kwargs['tag'] is not None and len(kwargs['tag']) == 2:
        kwargs['tag'] = tuple(kwargs['tag'])
    else:
        kwargs.pop('tag', None)
    _call(method, kwargs, debug)


def _run_once(args, cache: dict):
    from .loaders import load_model

    verbose = args.verbose
    set_global_overwrite_permission(args.overwrite)
    output_formats = (args.output_format.lower().split(',')
                      if args.output_format else None)
    if output_formats:
        bad = set(output_formats) - OUTPUT_FORMATS
        if bad:
            raise NotImplementedError(f'unsupported output format(s): {bad}')
    outputs = _finalize_outputs(args.inputs, args.output, args.output_dir,
                                output_formats)

    temperature = args.temperature
    increment = args.temperature_increment_on_fallback
    if increment is not None:
        temperature = tuple(
            float(t) / 100 for t in
            range(round(temperature * 100), 101, round(increment * 100)))
    else:
        temperature = [temperature]

    model_options = _parse_extra_options(args.model_option)
    transcribe_options = _parse_extra_options(args.transcribe_option)
    refine_options = _parse_extra_options(args.refine_option)
    locate_options = _parse_extra_options(args.locate_option)
    save_options = _parse_extra_options(args.save_option)

    # reference-compat flags
    if args.faster_whisper or args.mlx_whisper:
        raise NotImplementedError(
            'CTranslate2/MLX backends are not bundled; the PyTorch engine is '
            'the fast backend here. External engines plug in through '
            'transcribe_any / Aligner(inference_func=...), and a loaded '
            'faster-whisper model through modify_model.')
    for dep_flag in ('time_scale', 'ts_num', 'ts_noise'):
        if getattr(args, dep_flag) is not None:
            warnings.warn(f'--{dep_flag} is deprecated and has no effect '
                          '(same as the reference CLI).')
    if args.vad_onnx:
        warnings.warn('--vad_onnx has no effect; available VAD backends: '
                      'energy, nonvad, silero (torch.hub).')
    device = (args.device or 'cuda').lower()
    if device not in ('cuda', 'cpu'):
        raise ValueError(f'unknown device {args.device!r}; '
                         "expected 'cuda' or 'cpu'")
    if args.fp16 is not None and args.dtype is None:
        args.dtype = 'bfloat16' if args.fp16 else 'float32'
    if args.huggingface_whisper and not os.path.isdir(args.model):
        raise FileNotFoundError(
            f'--huggingface_whisper expects --model to be a local HF Whisper '
            f'directory (with config.json + safetensors); got {args.model!r}. '
            'Zero-egress environments cannot download from the Hub.')
    if args.tp is not None and not args.shard:
        warnings.warn('--tp has no effect without --shard.')
    writer = True   # this process writes the output files
    if args.shard:
        import torch.distributed as dist
        from .parallel import distributed_init
        distributed_init(backend='gloo' if device == 'cpu' else None)
        writer = not dist.is_initialized() or dist.get_rank() == 0
    if args.demucs and not args.denoiser:
        args.denoiser = 'demucs'
    denoiser_options = _parse_extra_options(
        (args.demucs_option or []) + (args.denoiser_option or []))
    if args.denoiser_output:
        denoiser_options['save_path'] = args.denoiser_output

    model_key = (args.model, args.model_dir, args.dtype,
                 args.dynamic_quantization, device, args.shard, args.tp,
                 tuple(sorted(model_options.items())))

    def model():
        # Lazy: JSON-only reprocessing (no align/refine) never needs the
        # checkpoint — same as the reference's cached-model closure
        # (cli.py:671-698).
        if cache.get('model_key') != model_key:
            import torch
            dtype = {None: None, 'float32': torch.float32,
                     'bfloat16': torch.bfloat16}[args.dtype]
            cache['model'] = _call(load_model, dict(
                name_or_path=args.model, download_root=args.model_dir,
                vocab_path=args.vocab, dtype=dtype,
                dq=args.dynamic_quantization, device=device,
                **model_options), args.debug)
            if args.shard:
                cache['model'].shard(tp=args.tp)
            cache['model_key'] = model_key
        return cache['model']

    for inp, out_paths in zip(args.inputs, outputs):
        if inp.lower().endswith('.json'):
            result = WhisperResult(inp)
        elif args.align is not None:
            text = (args.align[5:] if args.align.startswith('text:')
                    else open(args.align, encoding='utf-8').read())
            result = _call(model().align, dict(
                audio=inp, text=text, language=args.language,
                verbose=None if verbose == 0 else verbose == 2,
                original_split='\n' in text,
                vad=args.vad, vad_threshold=args.vad_threshold,
                denoiser=args.denoiser, only_voice_freq=args.only_voice_freq,
                suppress_silence=args.suppress_silence,
                min_word_dur=args.min_word_dur,
                regroup=args.regroup if args.regroup not in ('True', 'False')
                else args.regroup == 'True',
                **transcribe_options), args.debug)
        elif args.align_words is not None:
            source = WhisperResult(args.align_words)
            result = _call(model().align_words, dict(
                audio=inp, result=source, language=args.language,
                verbose=None if verbose == 0 else verbose == 2,
                **transcribe_options), args.debug)
        elif args.locate is not None:
            matches = _call(model().locate, dict(
                audio=inp, text=args.locate, language=args.language or 'en',
                verbose=verbose == 2, **locate_options), args.debug)
            for match in matches:
                print(match if isinstance(match, dict)
                      else match.to_display_str())
            continue
        else:
            method = getattr(model(), args.transcribe_method)
            tr_kwargs = dict(
                audio=inp,
                verbose=None if verbose == 0 else verbose == 2,
                task=args.task, language=args.language,
                temperature=temperature,
                word_timestamps=args.word_timestamps,
                regroup=args.regroup if args.regroup not in ('True', 'False')
                else args.regroup == 'True',
            )
            if args.transcribe_method in ('transcribe', 'transcribe_batched'):
                # options shared by the sequential and batched drivers
                tr_kwargs.update(
                    best_of=args.best_of, beam_size=args.beam_size,
                    patience=args.patience, length_penalty=args.length_penalty,
                    suppress_tokens=args.suppress_tokens,
                    initial_prompt=args.initial_prompt,
                    condition_on_previous_text=args.condition_on_previous_text,
                    compression_ratio_threshold=args.compression_ratio_threshold,
                    logprob_threshold=args.logprob_threshold,
                    no_speech_threshold=args.no_speech_threshold,
                    suppress_silence=args.suppress_silence,
                    suppress_word_ts=args.suppress_word_ts,
                    suppress_ts_tokens=args.suppress_ts_tokens,
                    use_word_position=args.use_word_position,
                    vad=args.vad, vad_threshold=args.vad_threshold,
                    q_levels=args.q_levels, k_size=args.k_size,
                    min_word_dur=args.min_word_dur,
                    min_silence_dur=args.min_silence_dur,
                    nonspeech_error=args.nonspeech_error,
                    gap_padding=args.gap_padding,
                    max_instant_words=args.max_instant_words,
                    avg_prob_threshold=args.avg_prob_threshold,
                    nonspeech_skip=args.nonspeech_skip,
                    denoiser=args.denoiser,
                    denoiser_options=denoiser_options or None,
                    only_voice_freq=args.only_voice_freq,
                    stream=False if args.no_stream else None,
                    only_ffmpeg=args.only_ffmpeg,
                    prepend_punctuations=args.prepend_punctuations,
                    append_punctuations=args.append_punctuations,
                    dynamic_heads=args.dynamic_heads,
                    aligner=args.aligner,
                    clip_timestamps=args.clip_timestamps,
                )
            if args.transcribe_method == 'transcribe_batched':
                tr_kwargs.update(batch_size=args.batch_size)
            if args.transcribe_method in ('transcribe',
                                          'transcribe_batched'):
                tr_kwargs.update(
                    mel_first=args.mel_first or None,
                    resume=args.resume,
                )
            tr_kwargs.update(transcribe_options)
            try:
                result = _call(method, tr_kwargs, args.debug)
            except KeyboardInterrupt:
                result = None
            if result is not None and result.unfinished_start >= 0:
                if writer and (args.save_unfinished or args.resume):
                    unfinished = splitext(out_paths[0])[0] + '-UNFINISHED.json'
                    result.save_as_json(unfinished)
                    print(f'Saved unfinished result: {unfinished}')
                continue
            if (writer and result is not None and args.delete_resume
                    and args.resume and os.path.isfile(args.resume)):
                os.remove(args.resume)

        if result is None:
            continue
        if args.refine:
            _call(model().refine, dict(
                audio=inp, result=result,
                verbose=None if verbose == 0 else verbose == 2,
                **refine_options), args.debug)
        if args.max_chars or args.max_words:
            result.split_by_length(max_chars=args.max_chars,
                                   max_words=args.max_words)
        for out_path in out_paths if writer else ():
            _save_result(result, out_path, args, save_options, args.debug)


def cli(argv: Optional[List[str]] = None):
    parser = build_parser()
    args = parser.parse_args(argv)
    cache: dict = {}
    try:
        _run_once(args, cache)
    except Exception:
        if not args.persist:
            raise
        import traceback
        traceback.print_exc()
    while args.persist:
        try:
            line = input('stable-ts-tpu-torch> ').strip()
        except (EOFError, KeyboardInterrupt):
            break
        if not line or line in ('exit', 'quit'):
            break
        try:
            new_args = parser.parse_args(shlex.split(line))
            new_args.persist = True
            _run_once(new_args, cache)
        except SystemExit:
            continue
        except Exception:
            import traceback
            traceback.print_exc()


if __name__ == '__main__':
    cli()
