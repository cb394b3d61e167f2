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
shared message, another data type.

The writers (write_hdf, wrhdf_3d) write with numpy alone (_write_numpy) on
every host, with h5py or without it (the card's host has none): the
structures above, laid out where h5py 3.14 / HDF5 1.14 puts them for the
same call (its 2048-byte metadata and small-data blocks, the global heap
collection of 4096 bytes, the object headers that a dimension scale's
attributes extend or continue), so the bytes are h5py's, the JAX package's
writer's. That writer takes float32 / float64 data of rank 1 to 3, with a
non-empty scale for every axis or with none (scales cast to the data's type,
as h5py's path does); anything else goes through h5py where it imports, and
raises ValueError by name where it does not.
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


# ------------------------------------------------------------------ writer
# The numpy writer lays the file out as h5py 3.14 does for write_hdf's calls
# (create the file; the 'Data' dataset, written at once; per axis i a 'dim<i>'
# dataset made a scale and attached to axis i):
#   * metadata in blocks of _META_BLOCK bytes, the first at 0: superblock,
#     root object header, root B-tree, local heap, Data's object header, the
#     root's symbol table node, dim1's object header, then (rank 3) the
#     continuation blocks of Data and dim1; a header that is last in its block
#     grows in place to hold its REFERENCE_LIST, one that is not continues;
#   * raw data in blocks from the end of the first metadata block: Data's,
#     dim1's, the global heap collection of DIMENSION_LIST's references;
#   * from rank 2, a second metadata block after the collection for the other
#     scales' headers, then their raw data.
_META_BLOCK = 2048
_GCOL_SIZE = 4096
_HEADER_SIZE = 256          # an object header's first allocation (its messages)
_HEAP_SIZE = 88             # the root group's local heap data segment
_BTREE_SIZE = 544           # a group B-tree node: K = 16
_SNOD_SIZE = 328            # a symbol table node: 2 K = 8 entries
_NULL, _FILL = 0x00, 0x05
_SCALE_CLASS = b'DIMENSION_SCALE\0'     # a dimension scale's CLASS attribute


def _pad8(b: bytes) -> bytes:
    return b + b'\0' * (-len(b) % 8)


def _u8(v: int) -> bytes:
    return int(v).to_bytes(8, 'little')


def _msg(kind: int, body: bytes, flags: int = 0) -> bytes:
    body = _pad8(body)
    return (kind.to_bytes(2, 'little') + len(body).to_bytes(2, 'little')
            + bytes([flags, 0, 0, 0]) + body)


def _dataspace(shape: tuple) -> bytes:
    """Version 1, with maximum dimensions (= the dimensions); () scalar."""
    flags = 1 if shape else 0
    dims = b''.join(_u8(d) for d in shape)
    return bytes([1, len(shape), flags, 0, 0, 0, 0, 0]) + dims + (dims if shape else b'')


def _float_type(dtype: np.dtype) -> bytes:
    if dtype.itemsize == 4:
        sign, exp_at, exp_bits, mant_bits, bias = 31, 23, 8, 23, 127
    else:
        sign, exp_at, exp_bits, mant_bits, bias = 63, 52, 11, 52, 1023
    return (bytes([0x11, 0x20, sign, 0]) + dtype.itemsize.to_bytes(4, 'little')
            + (0).to_bytes(2, 'little') + (8 * dtype.itemsize).to_bytes(2, 'little')
            + bytes([exp_at, exp_bits, 0, mant_bits]) + bias.to_bytes(4, 'little'))


def _string_type(size: int) -> bytes:
    return bytes([0x13, 0, 0, 0]) + size.to_bytes(4, 'little')


def _attribute(name: str, dtype: bytes, space: bytes, value: bytes) -> bytes:
    """An attribute message body (version 1: each part padded to 8)."""
    n = name.encode() + b'\0'
    return (bytes([1, 0]) + len(n).to_bytes(2, 'little') + len(dtype).to_bytes(2, 'little')
            + len(space).to_bytes(2, 'little') + _pad8(n) + _pad8(dtype) + _pad8(space)
            + value)


def _dimension_list(gcol: int, indices: list) -> bytes:
    """DIMENSION_LIST: per axis one variable-length list holding one object
    reference, stored as global heap object `indices[i]` of `gcol`."""
    vlen_ref = (bytes([0x19, 0, 0, 0]) + (16).to_bytes(4, 'little')
                + bytes([0x17, 0, 0, 0]) + (8).to_bytes(4, 'little'))
    value = b''.join((1).to_bytes(4, 'little') + _u8(gcol) + i.to_bytes(4, 'little')
                     for i in indices)
    return _attribute('DIMENSION_LIST', vlen_ref, _dataspace((len(indices),)), value)


def _reference_list(data_header: int, axis: int) -> bytes:
    """REFERENCE_LIST of a scale: one (dataset reference, axis) pair."""
    def member(name: str, offset: int, mtype: bytes) -> bytes:
        return (_pad8(name.encode() + b'\0') + offset.to_bytes(4, 'little')
                + bytes(4 + 4 + 4 + 16) + mtype)
    ref = bytes([0x17, 0, 0, 0]) + (8).to_bytes(4, 'little')
    uint32 = (bytes([0x10, 0, 0, 0]) + (4).to_bytes(4, 'little')
             + (0).to_bytes(2, 'little') + (32).to_bytes(2, 'little'))
    compound = (bytes([0x16, 2, 0, 0]) + (16).to_bytes(4, 'little')
                + member('dataset', 0, ref) + member('dimension', 8, uint32))
    value = _u8(data_header) + axis.to_bytes(4, 'little') + bytes(4)
    return _attribute('REFERENCE_LIST', compound, _dataspace((1,)), value)


def _scale_attributes(name: str) -> list:
    return [_msg(_ATTRIBUTE, _attribute('CLASS', _string_type(len(_SCALE_CLASS)),
                                        _dataspace(()), _SCALE_CLASS)),
            _msg(_ATTRIBUTE, _attribute('NAME', _string_type(len(name) + 1), _dataspace(()),
                                        name.encode() + b'\0'))]


def _dataset_messages(shape: tuple, dtype: np.dtype, address: int) -> list:
    nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    layout = bytes([3, 1]) + _u8(address) + _u8(nbytes)
    return [_msg(_DATASPACE, _dataspace(shape)), _msg(_DATATYPE, _float_type(dtype), 1),
            _msg(_FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]), 1), _msg(_LAYOUT, layout)]


def _header(messages: list, size: int, continued: int = 0) -> bytes:
    """A version 1 object header of `size` bytes of messages, the space
    left after them a null message; `continued`: the messages of its
    continuation block, which its count includes."""
    body = b''.join(messages)
    n = len(messages) + continued
    if len(body) < size:
        body += _msg(_NULL, bytes(size - len(body) - 8))
        n += 1
    if len(body) != size:
        raise AssertionError(f'object header messages of {len(body)} bytes, not {size}')
    return (bytes([1, 0]) + n.to_bytes(2, 'little') + (1).to_bytes(4, 'little')
            + size.to_bytes(4, 'little') + bytes(4) + body)


def _continuation(address: int, length: int) -> bytes:
    return _msg(_CONTINUATION, _u8(address) + _u8(length))


def _write_numpy(path: str, data: np.ndarray, scales: list):
    """The bytes h5py writes for write_hdf(path, data, scales) (see the
    layout above), with numpy alone."""
    dtype = data.dtype.newbyteorder('<')
    rank = data.ndim
    names = ['Data'] + [f'dim{i + 1}' for i in range(len(scales))]
    raw = [np.ascontiguousarray(data, dtype).tobytes()] + [
        np.ascontiguousarray(s, dtype).tobytes() for s in scales]
    header_alloc = 16 + _HEADER_SIZE
    grown = 16 + _HEADER_SIZE + 152     # a scale's header with its REFERENCE_LIST

    # metadata of the first block
    root, btree = 96, 136
    heap = btree + _BTREE_SIZE
    heap_data = heap + 32
    data_hdr = heap_data + _HEAP_SIZE
    snod = data_hdr + header_alloc
    hdr = {'Data': data_hdr}
    at = snod + _SNOD_SIZE
    if scales:
        hdr['dim1'] = at
        at += header_alloc if rank == 3 else grown
    conts = {}
    if scales and rank == 3:
        conts['Data'] = (at, 8 + 112)
        at += 8 + 112
        conts['dim1'] = (at, 8 + 184)
        at += 8 + 184
    # raw data from the end of the first metadata block
    addr = {'Data': _META_BLOCK}
    at = _META_BLOCK + len(raw[0])
    gcol = None
    if scales:
        addr['dim1'] = at
        gcol = at + len(raw[1])
        at = gcol + _GCOL_SIZE
        if rank > 1:             # the second metadata block, then the raw data
            block = at
            for i in range(2, rank + 1):
                hdr[f'dim{i}'] = block + (i - 2) * grown
            at = block + _META_BLOCK
            for i in range(2, rank + 1):
                addr[f'dim{i}'] = at
                at += len(raw[i])
    eof = at
    indices = list(range(1, rank + 1)) if rank < 3 else [3, 4, 5]

    buf = bytearray(eof)

    def put(address: int, b: bytes):
        buf[address:address + len(b)] = b

    # superblock (version 0) and the root group's symbol table entry
    put(0, _SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0]) + (4).to_bytes(2, 'little')
        + (16).to_bytes(2, 'little') + bytes(4) + _u8(0) + _u8(_UNDEFINED) + _u8(eof)
        + _u8(_UNDEFINED) + _u8(0) + _u8(root) + (1).to_bytes(4, 'little') + bytes(4)
        + _u8(btree) + _u8(heap))
    put(root, _header([_msg(_SYMBOL_TABLE, _u8(btree) + _u8(heap))], 24))
    # the names in the local heap, 8 bytes each, after the empty name at 0
    offsets = {n: 8 * (i + 1) for i, n in enumerate(names)}
    free = 8 * (len(names) + 1)
    put(heap, b'HEAP' + bytes(4) + _u8(_HEAP_SIZE) + _u8(free) + _u8(heap_data))
    put(heap_data, b''.join(_pad8(n.encode() + b'\0') for n in [''] + names)
        + _u8(1) + _u8(_HEAP_SIZE - free))
    put(btree, b'TREE' + bytes([0, 0]) + (1).to_bytes(2, 'little') + _u8(_UNDEFINED)
        + _u8(_UNDEFINED) + _u8(0) + _u8(snod) + _u8(offsets[names[-1]]))
    put(snod, b'SNOD' + bytes([1, 0]) + len(names).to_bytes(2, 'little') + b''.join(
        _u8(offsets[n]) + _u8(hdr[n]) + bytes(24) for n in names))

    # Data: its messages, DIMENSION_LIST in the header or its continuation
    msgs = _dataset_messages(data.shape, dtype, addr['Data'])
    if scales:
        dim_list = _msg(_ATTRIBUTE, _dimension_list(gcol, indices))
        if rank == 3:
            put(conts['Data'][0], dim_list)
            msgs.append(_continuation(*conts['Data']))
        else:
            msgs.append(dim_list)
    put(data_hdr, _header(msgs, _HEADER_SIZE, continued=int('Data' in conts)))
    for i in range(1, len(scales) + 1):
        name = f'dim{i}'
        msgs = (_dataset_messages((len(scales[i - 1]),), dtype, addr[name])
                + _scale_attributes(name))
        ref = _msg(_ATTRIBUTE, _reference_list(data_hdr, i - 1))
        if name in conts:
            put(conts[name][0], ref)
            put(hdr[name], _header(msgs + [_continuation(*conts[name])], _HEADER_SIZE,
                                   continued=1))
        else:
            put(hdr[name], _header(msgs + [ref], grown - 16))
    if gcol is not None:
        objects = b''.join(i.to_bytes(2, 'little') + bytes(6) + _u8(8) + _u8(hdr[f'dim{k + 1}'])
                           for k, i in enumerate(indices))
        put(gcol, b'GCOL' + bytes([1, 0, 0, 0]) + _u8(_GCOL_SIZE) + objects + bytes(8)
            + _u8(_GCOL_SIZE - 16 - len(objects)))
    for name, b in zip(names, raw):
        put(addr[name], b)
    with open(path, 'wb') as f:
        f.write(bytes(buf))


def _numpy_scales(data: np.ndarray, scales) -> list:
    """write_hdf's scales as the numpy writer takes them, or ValueError."""
    if data.dtype not in (np.float32, np.float64) or not 1 <= data.ndim <= 3:
        raise ValueError(f'without h5py, write_hdf takes float32 / float64 data of rank 1 '
                         f'to 3, got {data.dtype} {list(data.shape)}')
    scales = [] if scales is None else [np.asarray(s, data.dtype).reshape(-1) for s in scales]
    if scales and (len(scales) != data.ndim or any(s.size == 0 for s in scales)):
        raise ValueError('without h5py, write_hdf takes a non-empty scale for every axis '
                         f'or none, got sizes {[s.size for s in scales]} for rank {data.ndim}')
    return scales


def write_hdf(path: str, data: np.ndarray, scales=None):
    """Write a PSI-convention file with optional dimension scales: with numpy
    (_write_numpy, h5py's bytes) for every call it takes, else through h5py
    where it imports (ValueError where it does not)."""
    data = np.asarray(data)
    try:
        numpy_scales = _numpy_scales(data, scales)
    except ValueError:
        if h5py is None:
            raise
        _write_h5py(path, data, scales)
        return
    _write_numpy(path, data, numpy_scales)


def _write_h5py(path: str, data: np.ndarray, scales):
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
