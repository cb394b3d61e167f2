"""Native (C++) helpers, compiled on demand with g++ and loaded via ctypes
(sunerf_tpu/native/__init__.py, with its own copy of rice.cpp).

Currently: the RICE_1 tile decompressor for compressed FITS (rice.cpp), host
code of the data layer. It is built once per source (the library's name
carries the source's hash) into the port's build directory,
build/sunerf_tpu_torch/ beside the package (ops/build.py's BUILD_DIR). A
host without a working g++ decodes with the pure-Python decoder below
(slower, the same results); `decoder()` says which one this process uses.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

from sunerf_tpu_torch.ops.build import BUILD_DIR

logger = logging.getLogger(__name__)

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
_lib = None
_lib_tried = False


def _load_library():
    """Compile rice.cpp (once per source hash) and dlopen it; None when no
    working g++ is available."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    src = os.path.join(_SRC_DIR, 'rice.cpp')
    try:
        with open(src, 'rb') as f:
            tag = hashlib.sha256(f.read()).hexdigest()[:16]
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        so = str(BUILD_DIR / f'librice_{tag}.so')
        if not os.path.exists(so):
            tmp = so + f'.tmp{os.getpid()}'
            subprocess.run(['g++', '-O3', '-shared', '-fPIC', src, '-o', tmp],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic under concurrent builders
        lib = ctypes.CDLL(so)
        lib.rice_decode.restype = ctypes.c_int
        lib.rice_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int, ctypes.c_int]
        _lib = lib
    except Exception as e:  # pragma: no cover - depends on toolchain
        logger.warning('native rice decoder unavailable (%s); '
                       'decoding with the pure-Python decoder', e)
        _lib = None
    return _lib


def decoder() -> str:
    """'native' when rice.cpp built and loaded in this process, else
    'python'."""
    return 'native' if _load_library() is not None else 'python'


_RICE_PARAMS = {1: (3, 6, np.uint8), 2: (4, 14, np.int16), 4: (5, 25, np.int32)}


def _rice_decode_py(buf: bytes, npix: int, bytepix: int,
                    nblock: int) -> np.ndarray:
    """Pure-Python RICE_1 decoder (same algorithm as rice.cpp)."""
    fsbits, fsmax, dtype = _RICE_PARAMS[bytepix]
    bbits = bytepix * 8
    mask = (1 << bbits) - 1
    out = np.empty(npix, dtype)

    pos = 0      # bit cursor state
    acc, nbits = 0, 0
    data = memoryview(buf)

    def get(n):
        nonlocal pos, acc, nbits
        while nbits < n:
            if pos >= len(data):
                raise ValueError('truncated RICE stream')
            acc = (acc << 8) | data[pos]
            pos += 1
            nbits += 8
        nbits -= n
        v = (acc >> nbits) & ((1 << n) - 1)
        acc &= (1 << nbits) - 1
        return v

    def unary():
        nonlocal pos, acc, nbits
        count = 0
        while True:
            if nbits == 0:
                if pos >= len(data):
                    raise ValueError('truncated RICE stream')
                acc = data[pos]
                pos += 1
                nbits = 8
            if acc == 0:
                count += nbits
                nbits = 0
                continue
            top = acc.bit_length() - 1
            count += nbits - 1 - top
            nbits = top
            acc &= (1 << nbits) - 1
            return count

    half = 1 << (bbits - 1)

    def signed(v):  # unsigned bbits-wide value -> the output dtype's value
        return v - (1 << bbits) if bytepix > 1 and v >= half else v

    lastpix = get(bbits)
    i = 0
    while i < npix:
        fs = get(fsbits) - 1
        imax = min(i + nblock, npix)
        if fs < 0:
            out[i:imax] = signed(lastpix)
            i = imax
        else:
            direct = fs == fsmax
            while i < imax:
                if direct:
                    diff = get(bbits)
                else:
                    diff = (unary() << fs) | (get(fs) if fs else 0)
                if diff & 1:
                    diff = (~(diff >> 1)) & mask
                else:
                    diff >>= 1
                lastpix = (lastpix + diff) & mask
                out[i] = signed(lastpix)
                i += 1
    return out


def rice_decode(buf: bytes, npix: int, bytepix: int = 4,
                nblock: int = 32) -> np.ndarray:
    """Decompress one RICE_1 tile to npix pixels of width bytepix bytes."""
    if bytepix not in _RICE_PARAMS:
        raise ValueError(f'unsupported RICE BYTEPIX {bytepix}')
    lib = _load_library()
    dtype = _RICE_PARAMS[bytepix][2]
    if lib is not None:
        out = np.empty(npix, dtype)
        rc = lib.rice_decode(buf, len(buf),
                             out.ctypes.data_as(ctypes.c_void_p),
                             npix, bytepix, nblock)
        if rc == 0:
            return out
        raise ValueError(f'RICE stream decode failed (rc={rc}, '
                         f'npix={npix}, bytepix={bytepix})')
    return _rice_decode_py(buf, npix, bytepix, nblock)
