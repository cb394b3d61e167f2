"""Reader for SolarSoft (SSW) `.genx` files — IDL `savegen` XDR serialization
(a copy of sunerf_tpu/data/genx.py: numpy only; the port imports nothing of
the JAX package).

Clean-room implementation from the on-disk layout (the reference consumes
these via sunpy.io.special.read_genx at density_temperature.py:131; sunpy is
not available here and Python 3.13 removed xdrlib anyway).

File layout (all big-endian 32-bit words):
  version(int) xdr(int) creation(str) [version>=2: arch(str) os(str) release(str)]
  text(str) <template> <data>

  str       := len len bytes-padded-to-4   (length stored twice)
  template  := ndims dims[ndims] typecode nelem
               {typecode==8: ntags, tag-name strs..., child templates...}
  data      := values in template order; structs flattened depth-first;
               arrays as raw big-endian elements; strings as str.

IDL typecodes: 1 byte, 2 int16, 3 int32, 4 float32, 5 float64, 7 string,
8 struct, 12 uint16, 13 uint32, 14 int64, 15 uint64.
"""
from __future__ import annotations

import struct as _struct

import numpy as np

_DTYPES = {
    1: np.dtype('>u1'), 2: np.dtype('>i2'), 3: np.dtype('>i4'),
    4: np.dtype('>f4'), 5: np.dtype('>f8'), 12: np.dtype('>u2'),
    13: np.dtype('>u4'), 14: np.dtype('>i8'), 15: np.dtype('>u8'),
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def int(self) -> int:
        v = _struct.unpack_from('>i', self.data, self.pos)[0]
        self.pos += 4
        return v

    def string(self) -> str:
        n = self.int()
        if n == 0:  # empty strings carry a single length word
            return ''
        n2 = self.int()
        if n != n2:
            raise ValueError(f'corrupt genx string lengths {n} != {n2} @ {self.pos - 8}')
        raw = self.data[self.pos:self.pos + n]
        self.pos += (n + 3) // 4 * 4  # pad to word boundary
        return raw.decode('latin-1')

    def array(self, typecode: int, shape: tuple[int, ...]) -> np.ndarray:
        dt = _DTYPES[typecode]
        count = int(np.prod(shape)) if shape else 1
        nbytes = dt.itemsize * count
        # XDR pads sub-word element types to 4-byte multiples
        arr = np.frombuffer(self.data, dt, count=count, offset=self.pos)
        self.pos += (nbytes + 3) // 4 * 4
        return arr.reshape(shape) if shape else arr


def _read_template(r: _Reader) -> dict:
    ndims = r.int()
    dims = tuple(r.int() for _ in range(ndims))
    typecode = r.int()
    nelem = r.int()
    node = {'dims': dims, 'typecode': typecode, 'nelem': nelem}
    if typecode == 8:  # struct: tag names then child templates
        ntags = r.int()
        names = [r.string() for _ in range(ntags)]
        node['tags'] = [(name, _read_template(r)) for name in names]
    return node


def _read_data(r: _Reader, node: dict):
    typecode = node['typecode']
    if typecode == 8:
        count = max(node['nelem'], 1)
        records = [{name: _read_data(r, child) for name, child in node['tags']}
                   for _ in range(count)]
        return records[0] if count == 1 else records
    if typecode == 7:
        count = max(node['nelem'], 1) if node['dims'] else 1
        if node['dims'] and node['nelem'] > 1:
            return [r.string() for _ in range(node['nelem'])]
        return r.string()
    arr = r.array(typecode, node['dims'])
    if not node['dims'] or (node['dims'] == (1,) and node['nelem'] == 1):
        return arr.reshape(()).item() if arr.size == 1 else arr
    return arr


def read_genx(path: str) -> dict:
    """Parse a genx file into a nested dict. A 'HEADER' key carries the file
    metadata (mirroring sunpy's read_genx output shape)."""
    with open(path, 'rb') as f:
        r = _Reader(f.read())

    version = r.int()
    xdr = r.int()
    if version not in (1, 2) or xdr not in (0, 1):
        raise ValueError(f'not a genx file (version={version}, xdr={xdr})')
    header = {'VERSION': version, 'XDR': xdr, 'CREATION': r.string()}
    if version == 2:
        header['IDL_VERSION'] = {'ARCH': r.string(), 'OS': r.string(),
                                 'RELEASE': r.string()}
    header['TEXT'] = r.string()

    template = _read_template(r)
    data = _read_data(r, template)
    if not isinstance(data, dict):
        data = {'DATA': data}
    data['HEADER'] = header
    return data
