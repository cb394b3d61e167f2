"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), at
`build/sunerf_tpu_torch/<name>-<hash>.so` beside the package; the hash covers
the source, every shared header `csrc/*.cuh` and the flags, so an edited
source or header builds anew. A failed build raises. `defines` builds a
variant of a source with extra preprocessor macros (a measurement's
ablation; the hash covers them too). `launch` calls a
library's C entry on the current stream and raises on the CUDA error code it
returns; `check_tensor` is the wrappers' check of what they pass it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'sunerf_tpu_torch'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_loaded: dict = {}


def nvcc() -> str:
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels build on a machine '
                           'with the CUDA toolkit (PATH or /usr/local/cuda)')
    return path


def _flags(defines: tuple) -> tuple:
    return NVCC_FLAGS + tuple(f'-D{d}' for d in defines)


def library_path(name: str, defines: tuple = ()) -> Path:
    h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(_flags(defines)).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build(name: str, defines: tuple = ()) -> tuple[Path, str]:
    """Compile csrc/<name>.cu (with -D`defines`) unless its library is
    already built. Returns (library path, nvcc's report: registers, shared
    memory, spills; empty when the library was already there)."""
    out = library_path(name, defines)
    if out.exists():
        return out, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([nvcc(), *_flags(defines), '-o', str(tmp),
                           str(CSRC / f'{name}.cu')],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {name}.cu:\n{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get((name, defines))
        if lib is None:
            path, _ = build(name, defines)
            lib = _loaded[(name, defines)] = ctypes.CDLL(str(path))
        return lib


def signature(n_ptrs: int, n_ints: int, n_floats: int = 0) -> tuple:
    """ctypes argument types of a C entry that takes n_ptrs pointers, then
    n_ints ints, then n_floats floats (the stream follows them)."""
    return ((ctypes.c_void_p,) * n_ptrs + (ctypes.c_int,) * n_ints
            + (ctypes.c_float,) * n_floats)


def launch(name: str, argtypes: tuple, device, *args, defines: tuple = (), entry: str = None):
    """Calls the C entry sunerf_<entry> (by default sunerf_<name>) of
    csrc/<name>.cu (built on first use, with -D`defines`) with `args`, typed
    by `argtypes` (see `signature`), and the current stream of `device`.
    Raises on the CUDA error code it returns."""
    fn = getattr(load(name, defines), f'sunerf_{entry or name}')
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err}')


def check_tensor(name: str, t, shape, dtype, device):
    """Raises ValueError unless `t` is a contiguous `dtype` tensor of `shape`
    on `device`, as a kernel takes it."""
    if (not isinstance(t, torch.Tensor) or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or t.device != device):
        got = (f'{t.dtype} {list(t.shape)} on {t.device}' if isinstance(t, torch.Tensor)
               else repr(t))
        raise ValueError(f'{name} must be {dtype} {list(shape)} on {device}, got {got}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
