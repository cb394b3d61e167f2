"""PSI-convention HDF5 IO (Predictive Science MHD cubes), after
sunerf_tpu/data/psi_io.py: a 'Data' dataset with optional HDF5 dimension
scales attached per axis. rdhdf_3d -> (r, theta, phi, data) with data
indexed [phi, theta, r] (C order of the Fortran (r, th, phi) cube).

The reader needs numpy alone (no h5py): it reads the subset of HDF5 that
the writer below produces (h5py 3.14 / HDF5 1.14 with its default, earliest
file format):
  * superblock version 0, the root group's symbol table (a version 1
    B-tree of symbol table nodes and a local heap of names);
  * version 1 object headers, with their continuation blocks;
  * the dataspace, datatype (little-endian IEEE float32 / float64) and
    contiguous data layout messages (a dataset never written reads as
    zeros, as HDF5 fills it);
  * the DIMENSION_LIST attribute of 'Data': one variable-length list of
    object references a dimension, each list in the global heap, each
    reference the object header of a scale dataset (the scales'
    REFERENCE_LIST back-links are not read).
Anything else raises ValueError naming what it met: another superblock
version, a chunked or compact layout, a filter pipeline (compression), a
shared message, another data type. The writers need h5py, as the JAX
package's do; only CPU-host tools and tests write files.
"""
from __future__ import annotations

import numpy as np

try:
    import h5py
except ImportError:  # the card's host has no h5py: the reader does not need it
    h5py = None

_SIGNATURE = b'\x89HDF\r\n\x1a\n'
_UNDEFINED = 0xFFFFFFFFFFFFFFFF
# object header message types
_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = (
    0x01, 0x03, 0x08, 0x0B, 0x0C, 0x10, 0x11)
_FLOAT, _REFERENCE, _VLEN = 1, 7, 9    # datatype classes


def _require_h5py():
    if h5py is None:
        raise ImportError('h5py is required to write PSI HDF5 files (the reader, '
                          'read_hdf, needs numpy alone)')


class _File:
    """The bytes of one HDF5 file and the reads of its structures."""

    def __init__(self, path: str):
        with open(path, 'rb') as f:
            self.buf = f.read()
        self.path = path
        if self.buf[:8] != _SIGNATURE:
            raise ValueError(f'{path}: not an HDF5 file (no signature at byte 0)')
        version = self.buf[8]
        if version != 0:
            raise ValueError(f'{path}: HDF5 superblock version {version}; the reader '
                             'takes version 0')
        self.o, self.l = self.buf[13], self.buf[14]   # sizes of offsets and lengths
        if self.o != 8 or self.l != 8:
            raise ValueError(f'{path}: offsets of {self.o} and lengths of {self.l} bytes; '
                             'the reader takes 8 and 8')
        # base address, free space, end of file, driver block: 4 offsets
        at = 24
        self.base = self._u(at, 8)
        if self.buf[at + 24:at + 32] != b'\xff' * 8:
            raise ValueError(f'{path}: a driver information block; the reader takes none')
        self.root_entry = at + 32

    def _u(self, at: int, size: int) -> int:
        return int.from_bytes(self.buf[at:at + size], 'little')

    def addr(self, at: int) -> int:
        return self._u(at, 8)

    def _abs(self, address: int) -> int:
        return self.base + address

    # ---------------------------------------------------------------- groups

    def root_children(self) -> dict:
        """{name: object header address} of the root group's links."""
        header = self.addr(self.root_entry + 8)
        msgs = self.messages(header)
        if _SYMBOL_TABLE not in msgs:
            raise ValueError(f'{self.path}: the root group has no symbol table message '
                             '(a newer group format); the reader takes the version 0 '
                             'superblock layout')
        body = msgs[_SYMBOL_TABLE][0]
        btree, heap = self.addr(body), self.addr(body + 8)
        names = self._local_heap(heap)
        children = {}
        self._group_btree(btree, names, children)
        return children

    def _local_heap(self, at: int) -> int:
        at = self._abs(at)
        if self.buf[at:at + 4] != b'HEAP':
            raise ValueError(f'{self.path}: no local heap at {at}')
        return self._abs(self.addr(at + 24))

    def _name(self, heap_data: int, offset: int) -> str:
        start = heap_data + offset
        end = self.buf.index(b'\0', start)
        return self.buf[start:end].decode()

    def _group_btree(self, at: int, heap_data: int, out: dict):
        at = self._abs(at)
        if self.buf[at:at + 4] != b'TREE' or self.buf[at + 4] != 0:
            raise ValueError(f'{self.path}: no group B-tree node at {at}')
        level, used = self.buf[at + 5], self._u(at + 6, 2)
        # keys (heap offsets, 8 bytes) and children (addresses) alternate
        # after the two sibling addresses: key_0, child_0, key_1, ...
        for i in range(used):
            child = self.addr(at + 24 + 8 + 16 * i)
            if level:
                self._group_btree(child, heap_data, out)
            else:
                self._symbol_node(child, heap_data, out)

    def _symbol_node(self, at: int, heap_data: int, out: dict):
        at = self._abs(at)
        if self.buf[at:at + 4] != b'SNOD':
            raise ValueError(f'{self.path}: no symbol table node at {at}')
        for i in range(self._u(at + 6, 2)):
            entry = at + 8 + 40 * i
            out[self._name(heap_data, self.addr(entry))] = self.addr(entry + 8)

    # --------------------------------------------------------- object headers

    def messages(self, header: int) -> dict:
        """{type: [body offset, ...]} of a version 1 object header and its
        continuation blocks; a shared message raises."""
        at = self._abs(header)
        if self.buf[at] != 1:
            raise ValueError(f'{self.path}: object header version {self.buf[at]} at '
                             f'{header}; the reader takes version 1')
        n_msgs = self._u(at + 2, 2)
        blocks = [(at + 16, self._u(at + 8, 4))]
        out: dict = {}
        seen = 0
        while blocks and seen < n_msgs:
            start, size = blocks.pop(0)
            pos = start
            while pos + 8 <= start + size and seen < n_msgs:
                kind, length, flags = self._u(pos, 2), self._u(pos + 2, 2), self.buf[pos + 4]
                body = pos + 8
                seen += 1
                if flags & 0x02:
                    raise ValueError(f'{self.path}: a shared message (type {kind}); the '
                                     'reader takes messages stored in their header')
                if kind == _CONTINUATION:
                    blocks.append((self._abs(self.addr(body)), self._u(body + 8, 8)))
                else:
                    out.setdefault(kind, []).append(body)
                pos = body + length
        return out

    def _dataspace(self, at: int) -> tuple:
        version, rank = self.buf[at], self.buf[at + 1]
        if version == 1:
            dims_at = at + 8
        elif version == 2:
            if self.buf[at + 3] == 2:       # null dataspace
                return ()
            dims_at = at + 4
        else:
            raise ValueError(f'{self.path}: dataspace message version {version}')
        return tuple(self._u(dims_at + 8 * i, 8) for i in range(rank))

    def _datatype(self, at: int) -> tuple:
        """(class, size) of a datatype message."""
        return self.buf[at] & 0x0F, self._u(at + 4, 4)

    def _float_dtype(self, at: int) -> np.dtype:
        cls, size = self._datatype(at)
        if cls != _FLOAT:
            raise ValueError(f'{self.path}: data type class {cls}; the reader takes '
                             'IEEE floats (class 1)')
        if self.buf[at + 1] & 0x01:
            raise ValueError(f'{self.path}: a big-endian float; the reader takes '
                             'little-endian float32 and float64')
        if size not in (4, 8):
            raise ValueError(f'{self.path}: a float of {size} bytes; the reader takes '
                             'float32 and float64')
        return np.dtype('<f4' if size == 4 else '<f8')

    def dataset(self, header: int) -> np.ndarray:
        msgs = self.messages(header)
        if _FILTERS in msgs:
            raise ValueError(f'{self.path}: a filter pipeline (compression); the reader '
                             'takes unfiltered contiguous datasets')
        for kind, what in ((_DATASPACE, 'dataspace'), (_DATATYPE, 'datatype'),
                           (_LAYOUT, 'data layout')):
            if kind not in msgs:
                raise ValueError(f'{self.path}: a dataset without a {what} message')
        shape = self._dataspace(msgs[_DATASPACE][0])
        dtype = self._float_dtype(msgs[_DATATYPE][0])
        at = msgs[_LAYOUT][0]
        version = self.buf[at]
        if version != 3:
            raise ValueError(f'{self.path}: data layout message version {version}; the '
                             'reader takes version 3')
        layout = self.buf[at + 1]
        if layout != 1:
            name = {0: 'compact', 2: 'chunked', 3: 'virtual'}.get(layout, str(layout))
            raise ValueError(f'{self.path}: a {name} data layout; the reader takes '
                             'contiguous datasets')
        address, size = self.addr(at + 2), self._u(at + 10, 8)
        count = int(np.prod(shape, dtype=np.int64))
        if size != count * dtype.itemsize:
            raise ValueError(f'{self.path}: {size} bytes of data for shape {shape} of '
                             f'{dtype}')
        if address == _UNDEFINED:
            return np.zeros(shape, dtype.newbyteorder('='))
        start = self._abs(address)
        data = np.frombuffer(self.buf, dtype, count, start).reshape(shape)
        return data.astype(dtype.newbyteorder('='))

    # ------------------------------------------------------------- attributes

    def attribute(self, header: int, wanted: str):
        """(datatype offset, dataspace shape, data offset) of the named
        attribute of an object, or None."""
        for at in self.messages(header).get(_ATTRIBUTE, []):
            version = self.buf[at]
            name_size, type_size, space_size = (self._u(at + 2, 2), self._u(at + 4, 2),
                                                self._u(at + 6, 2))
            if version == 1:
                pad = lambda n: -(-n // 8) * 8  # noqa: E731
                name_at = at + 8
            elif version in (2, 3):
                pad = lambda n: n  # noqa: E731
                name_at = at + 8 + (version == 3)
            else:
                raise ValueError(f'{self.path}: attribute message version {version}')
            name = self.buf[name_at:name_at + name_size].rstrip(b'\0').decode()
            type_at = name_at + pad(name_size)
            space_at = type_at + pad(type_size)
            if name == wanted:
                return type_at, self._dataspace(space_at), space_at + pad(space_size)
        return None

    def _global_object(self, collection: int, index: int) -> int:
        """Offset of object `index`'s data in the global heap collection."""
        at = self._abs(collection)
        if self.buf[at:at + 4] != b'GCOL':
            raise ValueError(f'{self.path}: no global heap collection at {collection}')
        end, pos = at + self._u(at + 8, 8), at + 16
        while pos + 16 <= end:
            obj, size = self._u(pos, 2), self._u(pos + 8, 8)
            if obj == index:
                return pos + 16
            if obj == 0:            # free space
                break
            pos += 16 + -(-size // 8) * 8
        raise ValueError(f'{self.path}: no object {index} in the global heap at '
                         f'{collection}')

    def dimension_scales(self, header: int, rank: int) -> list:
        """Per dimension, the object header address of its first attached
        scale, or None."""
        attr = self.attribute(header, 'DIMENSION_LIST')
        if attr is None:
            return [None] * rank
        type_at, shape, data_at = attr
        cls, size = self._datatype(type_at)
        base = type_at + 8        # a variable-length type's base type follows
        if cls != _VLEN or (self.buf[base] & 0x0F) != _REFERENCE:
            raise ValueError(f'{self.path}: DIMENSION_LIST of type class {cls}; the '
                             'reader takes variable-length object references')
        if shape != (rank,):
            raise ValueError(f'{self.path}: DIMENSION_LIST of shape {shape} for a '
                             f'rank-{rank} dataset')
        scales = []
        for i in range(rank):
            # a variable-length element: count (4), collection address, index (4)
            at = data_at + i * size
            count = self._u(at, 4)
            if count == 0:
                scales.append(None)
                continue
            refs = self._global_object(self.addr(at + 4), self._u(at + 12, 4))
            scales.append(self.addr(refs))
        return scales


def read_hdf(path: str):
    """Read a PSI HDF5 file -> (scales list, data). Scales are returned in
    dims order (axis 0 first); missing scales are empty arrays. numpy
    alone: the subset of HDF5 in the module's docstring."""
    f = _File(path)
    children = f.root_children()
    if 'Data' not in children:
        raise ValueError(f'{path}: no Data dataset in the root group')
    data = f.dataset(children['Data'])
    scales = [np.array([]) if at is None else f.dataset(at)
              for at in f.dimension_scales(children['Data'], data.ndim)]
    return scales, data


def rdhdf_1d(path: str):
    scales, data = read_hdf(path)
    return scales[0], data


def rdhdf_2d(path: str):
    scales, data = read_hdf(path)
    return scales[0], scales[1], data


def rdhdf_3d(path: str):
    """-> (x, y, z, data): x/y/z are the axis-0/1/2 dimension scales. For PSI
    MHD cubes the caller interprets these as (r, theta, phi) with data
    [phi, theta, r] (reference mhd_model.py:62)."""
    scales, data = read_hdf(path)
    return scales[0], scales[1], scales[2], data


def write_hdf(path: str, data: np.ndarray, scales=None):
    """Write a PSI-convention file with optional dimension scales (h5py)."""
    _require_h5py()
    data = np.asarray(data)
    with h5py.File(path, 'w') as f:
        dset = f.create_dataset('Data', data=data)
        if scales is not None:
            for i, s in enumerate(scales):
                s = np.asarray(s, data.dtype)
                if s.size == 0:
                    continue
                name = f'dim{i + 1}'
                f[name] = s
                f[name].make_scale(name)
                dset.dims[i].attach_scale(f[name])


def wrhdf_3d(path: str, x, y, z, data):
    write_hdf(path, data, scales=[x, y, z])
