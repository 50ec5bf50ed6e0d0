"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all of them at once, and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``. Nothing
includes PyTorch's headers, so a cold build takes seconds, not minutes.
The build runs at first use, from the package's own sources, into
``_build/<hash of the sources and flags>/`` inside the package directory;
a changed source gets a fresh directory, an unchanged one reuses the
library.

Each C entry point launches on the caller's stream, allocates nothing, and
returns ``cudaGetLastError()`` so a refused launch (too many threads, too
much shared memory) raises here instead of passing silently.

ptxas reports each kernel's registers, spills and shared memory (``-Xptxas
-v``); the build keeps the report beside the library as ``ptxas.log``
(:func:`kernel_resources` reads it).

``launches`` counts kernel launches per wrapper: each wrapper in ``ops/``
adds one where it launches its kernel, so a run can show that the main
path went through the kernels. A replay of a captured CUDA graph adds the
launches its capture counted (``models/whisper/step_graph.py``), so the
counts are those of the eager calls it stands for.
"""
import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent
_SRC_DIR = _PKG_DIR / 'csrc'
_BUILD_ROOT = _PKG_DIR / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-Xcompiler', '-fPIC', '-lineinfo', '-Xptxas', '-v')

# ptxas's report (registers, spills, shared memory per kernel), beside the library
PTXAS_LOG = 'ptxas.log'

# name of each kernel wrapper -> launches since the last reset
launches = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of csrc/*.cu's entry points (all return a cudaError_t as int)
_SIGNATURES = {
    # q, k, v, o, lse (or null), dtype, B, H, T, S, dh, q/k/v/o batch+row
    # strides, scale, stream
    'flash_attn_fwd': [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _F, _P],
    # q, k, v, dO, lse, D, dk, dv, dtype, B, H, T, S, dh, q/k/v batch+row
    # strides, scale, stream
    'flash_attn_bwd_dkv': [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _LL, _LL, _LL, _LL, _LL, _LL, _F, _P],
    # ... as flash_attn_bwd_dkv with dq in place of dk, dv
    'flash_attn_bwd_dq': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _LL, _LL, _LL, _LL, _LL, _LL, _F, _P],
    # q, k, v, k_scale, v_scale, out, cache dtype, B, H, dh, n_keys,
    # kv batch stride, kv row stride, scale batch stride, then the position
    # as a device int64 (or null: n_keys then counts the keys), stream
    'self_attn_decode': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _LL, _LL, _LL, _P, _P],
    # ... as self_attn_decode to the scale batch stride, then the buffers'
    # addresses as a device array (or null: k, v and the scales are
    # addresses, not offsets), stream
    'cross_attn_decode': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _LL, _LL, _LL, _P, _P],
    # ... as self_attn_decode to the scale batch stride, then anc, anc row
    # stride, g, stream
    'self_attn_decode_beam': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _LL, _LL, _LL, _P, _LL, _I, _P],
    # ... as self_attn_decode to the scale batch stride (batch = windows),
    # then g, stream
    'cross_attn_decode_group': [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _LL, _LL, _LL, _I, _P],
    # x, emb, suppress, silence, silence row stride, flags, scratch, out,
    # dtype, B, d, V, ts_begin, eot, grammar, stream
    'logit_epilogue': [_P, _P, _P, _P, _LL, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _P],
    # x, cost, B, N, M, stream
    'dtw_cost': [_P, _P, _I, _I, _I, _P],
    # x, q, scale, out, x dtype, M, N, K, stream
    'woq_matmul': [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    # x, emb, out, dtype, M, d, V, stream
    'vocab_proj': [_P, _P, _P, _I, _I, _I, _I, _P],
    # blocks, threads, stream: an empty kernel (the launch floor, not counted)
    'empty_launch': [_I, _I, _P],
}
# entry points that return something other than a cudaError_t
_RESTYPES = {
    'epilogue_partial_floats': ([_I, _I], ctypes.c_longlong),  # (B, V) -> floats
}

_LIB = None
_LOCK = threading.Lock()


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset."""
    return dict(launches)


def reset_launch_counts() -> None:
    launches.clear()


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``, then ``$PATH``, then the toolkit's
    default prefix. Raises when there is none: the kernels have no
    substitute."""
    candidates = []
    if os.environ.get('CUDA_HOME'):
        candidates.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    on_path = shutil.which('nvcc')
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        'nvcc not found (looked in $CUDA_HOME/bin, $PATH and '
        '/usr/local/cuda/bin): the CUDA kernels of stable_ts_tpu_torch '
        'cannot be built')


def _sources():
    return sorted(_SRC_DIR.glob('*.cu')), sorted(_SRC_DIR.glob('*.cuh'))


def source_hash() -> str:
    cus, headers = _sources()
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if no library for the current sources exists.
    Returns the library's path."""
    out_dir = _BUILD_ROOT / source_hash()
    lib_path = out_dir / 'libkernels.so'
    if lib_path.is_file():
        return lib_path
    nvcc = find_nvcc()
    cus, _ = _sources()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    objs = [out_dir / f'{cu.stem}.{tag}.o' for cu in cus]
    compiles = [subprocess.Popen([nvcc, *NVCC_FLAGS, f'-I{_SRC_DIR}', '-c',
                                  '-o', str(obj), str(cu)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                 text=True)
                for cu, obj in zip(cus, objs)]
    errors, logs = [], []
    for cu, proc in zip(cus, compiles):
        _, err = proc.communicate()
        logs.append(f'== {cu.name}\n{err}')
        if proc.returncode != 0:
            errors.append(f'{cu.name} ({proc.returncode}):\n{err}')
    if errors:
        raise RuntimeError('nvcc failed: ' + '\n'.join(errors))
    (out_dir / PTXAS_LOG).write_text('\n'.join(logs))
    tmp = out_dir / f'libkernels.{tag}.so'
    link = subprocess.run([nvcc, *NVCC_FLAGS, '-shared', '-o', str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError(f'nvcc link failed ({link.returncode}):\n{link.stderr}')
    os.replace(tmp, lib_path)
    for obj in objs:
        obj.unlink()
    return lib_path


def kernel_resources(lib_path: Path) -> dict:
    """{mangled kernel name: {'registers', 'spill_stores', 'spill_loads',
    'smem'}} from the ptxas report of the build at ``lib_path`` (static
    shared memory only; the flash kernels take theirs dynamically)."""
    found, name = {}, None
    for line in (lib_path.parent / PTXAS_LOG).read_text().splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", line)
        if m:
            name = m.group(1)
            found.setdefault(name, {})
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line)
        if m and name:
            found[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r'Used (\d+) registers(?:.*?(\d+) bytes smem)?', line)
        if m and name:
            found[name].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return found


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            for name, (argtypes, restype) in _RESTYPES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIB = handle
    return _LIB


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t from a kernel entry point."""
    if err != 0:
        raise RuntimeError(f'{name}: CUDA error {err} at launch')


def stream_ptr(tensor) -> int:
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream


# dtype codes shared with csrc/common.cuh (DTYPE_I4: int8 bytes that each
# pack two int4 values, which no torch dtype names)
DTYPE_F32, DTYPE_BF16, DTYPE_I8, DTYPE_I4 = 0, 1, 2, 3


def dtype_code(dtype) -> int:
    import torch
    codes = {torch.float32: DTYPE_F32, torch.bfloat16: DTYPE_BF16,
             torch.int8: DTYPE_I8}
    if dtype not in codes:
        raise TypeError(f'unsupported kernel dtype {dtype}')
    return codes[dtype]
