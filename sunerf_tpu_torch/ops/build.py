"""Build the port's CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` is compiled by nvcc for sm_90a into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), at
`build/sunerf_tpu_torch/<name>-<hash>.so` beside the package; the hash covers
the source, every shared header `csrc/*.cuh` and the flags, so an edited
source or header builds anew. A failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

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


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    for header in sorted(CSRC.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{h.hexdigest()[:16]}.so'


def build(name: str) -> tuple[Path, str]:
    """Compile csrc/<name>.cu unless its library is already built. Returns
    (library path, nvcc's report: registers, shared memory, spills; empty
    when the library was already there)."""
    out = library_path(name)
    if out.exists():
        return out, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                           str(CSRC / f'{name}.cu')],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {name}.cu:\n{proc.stdout}\n{proc.stderr}')
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def load(name: str) -> ctypes.CDLL:
    """The built library of csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path, _ = build(name)
            lib = _loaded[name] = ctypes.CDLL(str(path))
        return lib
