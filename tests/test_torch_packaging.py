"""The port as it ships: the wheel carries the sources the port builds at
run time, and the host code the port copies from stable_ts_tpu stays a
copy.

The wheel is built offline from a copy of the tree. It must list the
native audio decoder's source and every CUDA source and header. Each
copied file must equal its stable_ts_tpu original token for token once
the package names are masked and the docstrings are left out; comments
and every other string count. The differences that are intended are
named below, file by file."""
import ast
import io
import re
import shutil
import subprocess
import sys
import tokenize
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / 'stable_ts_tpu'
PORT_PKG = REPO / 'stable_ts_tpu_torch'


def test_wheel_ships_the_native_and_cuda_sources(tmp_path):
    pytest.importorskip('setuptools')
    pytest.importorskip('wheel')
    src = tmp_path / 'src'
    ignore = shutil.ignore_patterns('__pycache__', '*.so', '_build', '*.pyc')
    src.mkdir()
    shutil.copy(REPO / 'setup.py', src)
    for pkg in (JAX_PKG, PORT_PKG):
        shutil.copytree(pkg, src / pkg.name, ignore=ignore)
    out = tmp_path / 'wheel'
    proc = subprocess.run(
        [sys.executable, '-m', 'pip', 'wheel', '--no-deps',
         '--no-build-isolation', '--no-index', '-q', '-w', str(out), str(src)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    (wheel,) = out.glob('*.whl')
    names = set(zipfile.ZipFile(wheel).namelist())
    assert 'stable_ts_tpu_torch/native/audioio.cpp' in names
    assert 'stable_ts_tpu/native/audioio.cpp' in names
    for pattern in ('*.cu', '*.cuh'):
        sources = sorted((PORT_PKG / 'csrc').glob(pattern))
        assert sources
        for path in sources:
            assert f'stable_ts_tpu_torch/csrc/{path.name}' in names


# the files the port copies (PR 3's list, then options.py, result/repair.py
# and non_whisper/ with align, then video_output.py and backends/ with the CLI)
COPIES = [
    '_version.py', 'constants.py', 'defaults.py', 'utils.py', 'text_output.py',
    'options.py',
    'result/__init__.py', 'result/_common.py', 'result/find.py',
    'result/segment.py', 'result/whisper_result.py', 'result/word.py',
    'result/repair.py',
    'stabilization/__init__.py', 'stabilization/energy_vad.py',
    'stabilization/nonvad.py', 'stabilization/silence.py',
    'stabilization/silero_vad.py', 'stabilization/utils.py',
    'audio/__init__.py', 'audio/decode.py', 'audio/denoiser.py',
    'audio/loader.py', 'audio/output.py', 'audio/source.py',
    'audio/streaming.py', 'audio/utils.py',
    'native/__init__.py', 'native/audioio.cpp',
    'models/whisper/tokenizer.py', 'models/whisper/languages.py',
    'models/whisper/alignment_heads.py',
    'non_whisper/__init__.py', 'non_whisper/alignment.py',
    'non_whisper/refinement.py', 'non_whisper/transcribe.py',
    'video_output.py', 'backends/__init__.py', 'backends/faster_whisper.py',
]

# top-level functions of the JAX file that the copy leaves out, and why
LEFT_OUT = {
    # the switch turns on JAX's persistent compilation cache: the port
    # imports no jax
    'utils.py': {'enable_compilation_cache'},
}


# string literals the copy rewords, by file: the port's literal, then the
# JAX original's
REWORDED = {
    # the hint names the engine the port runs
    'backends/faster_whisper.py': {
        "'faster-whisper is not installed. The PyTorch engine '":
            "'faster-whisper is not installed. The JAX/XLA engine '",
    },
}


def _mask(text: str) -> str:
    text = re.sub(r'stable_ts_tpu(_torch)?\b', 'PKG', text)
    # upstream notes: the JAX package names a local checkout of stable-ts
    # by its path, the port by the project's name
    return re.sub(r'[\w/]*/reference/stable_whisper/',
                  'stable-ts stable_whisper/', text)


def _python_tokens(path: Path, left_out=(), reworded=None):
    src = path.read_text()
    tree = ast.parse(src)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if (isinstance(first, ast.Expr)
                    and isinstance(first.value, ast.Constant)
                    and isinstance(first.value.value, str)):
                docstrings.add((first.lineno, first.col_offset))
    dropped = set()
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name in left_out:
            first = min([node.lineno] + [d.lineno for d in node.decorator_list])
            dropped.update(range(first, node.end_lineno + 1))
    # indentation counts as the column of each line's first token (the
    # INDENT and DEDENT tokens of a left-out function fall on its
    # neighbours' lines)
    tokens, line = [], 0
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if (tok.type in (tokenize.NL, tokenize.INDENT, tokenize.DEDENT)
                or tok.start[0] in dropped
                or (tok.type == tokenize.STRING and tok.start in docstrings)):
            continue
        column = tok.start[1] if tok.start[0] != line else None
        line = tok.end[0]
        string = (reworded or {}).get(tok.string, tok.string)
        tokens.append((tok.type, _mask(string), column))
    return tokens


@pytest.mark.parametrize('rel', COPIES)
def test_copy_equals_the_jax_original(rel):
    ours, theirs = PORT_PKG / rel, JAX_PKG / rel
    if rel.endswith('.py'):
        left_out = LEFT_OUT.get(rel, set())
        got = _python_tokens(ours, reworded=REWORDED.get(rel))
        want = _python_tokens(theirs, left_out)
        for name in left_out:
            assert f'def {name}(' in theirs.read_text()
            assert f'def {name}(' not in ours.read_text()
    else:
        got = _mask(ours.read_text()).splitlines()
        want = _mask(theirs.read_text()).splitlines()
    assert got == want


# the layers above the model: a module under ops/ or models/ that imports
# one of them points the arrow up
ABOVE_THE_MODEL = ('batched', 'transcribe', 'alignment', 'loaders', 'cli')


def _imported_modules(path: Path):
    """Every module an import statement of ``path`` names, relative ones
    resolved against its package; ``from pkg import name`` also yields
    ``pkg.name``. Read from the syntax tree: nothing is imported."""
    package = list(path.relative_to(REPO).parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            parts = package[:len(package) - node.level + 1] if node.level else []
            base = '.'.join(parts + ([node.module] if node.module else []))
            yield base
            yield from (f'{base}.{alias.name}' for alias in node.names)


def test_ops_and_models_import_nothing_above_the_model():
    forbidden = tuple(f'{PORT_PKG.name}.{name}' for name in ABOVE_THE_MODEL)
    sources = [p for layer in ('ops', 'models')
               for p in sorted((PORT_PKG / layer).rglob('*.py'))]
    assert sources
    wrong = sorted({f'{p.relative_to(REPO)}: {mod}' for p in sources
                    for mod in _imported_modules(p)
                    if any(mod == f or mod.startswith(f + '.')
                           for f in forbidden)})
    assert not wrong, wrong
