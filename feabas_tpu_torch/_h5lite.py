"""A minimal pure-Python HDF5 writer and reader with the h5py calls the
stitch path makes, for hosts without h5py.

``feabas_tpu_torch.storage`` imports this module in place of h5py on a
host that lacks h5py (the GPU machine this port targets has no HDF5 at
all). Where h5py is installed it is always used.

What it writes is standard HDF5 that h5py and the HDF5 library read:
superblock version 2, version-2 object headers, groups with compact link
storage, contiguous uncompressed datasets of little-endian integers,
IEEE floats and h5py-style booleans (an int8 enum FALSE/TRUE), scalar or
N-d. ``compression`` is accepted and ignored. It reads the same subset
(files it wrote, or h5py files written with ``libver='latest'`` and no
filters); anything else raises ``OSError``.

API subset: ``File(path, mode)`` with mode 'r' or 'w', used as a context
manager or closed with ``close()``; ``create_dataset(name, data=...)``
with '/'-separated names creating intermediate groups; ``f[name]``;
``name in f``; ``keys()``; ``ds[()]``.
"""

import struct

import numpy as np

_SIG = b'\x89HDF\r\n\x1a\n'
_UNDEF = 0xFFFFFFFFFFFFFFFF
_M = 0xFFFFFFFF


def _rot(x, k):
    return ((x << k) | (x >> (32 - k))) & _M


def lookup3(data, initval=0):
    """Jenkins lookup3 ``hashlittle``: the HDF5 metadata checksum."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M
    i = 0
    while n > 12:
        a = (a + int.from_bytes(data[i:i + 4], 'little')) & _M
        b = (b + int.from_bytes(data[i + 4:i + 8], 'little')) & _M
        c = (c + int.from_bytes(data[i + 8:i + 12], 'little')) & _M
        a = (a - c) & _M; a ^= _rot(c, 4); c = (c + b) & _M
        b = (b - a) & _M; b ^= _rot(a, 6); a = (a + c) & _M
        c = (c - b) & _M; c ^= _rot(b, 8); b = (b + a) & _M
        a = (a - c) & _M; a ^= _rot(c, 16); c = (c + b) & _M
        b = (b - a) & _M; b ^= _rot(a, 19); a = (a + c) & _M
        c = (c - b) & _M; c ^= _rot(b, 4); b = (b + a) & _M
        n -= 12
        i += 12
    if n == 0:
        return c
    tail = bytes(data[i:]) + bytes(12 - n)
    a = (a + int.from_bytes(tail[0:4], 'little')) & _M
    b = (b + int.from_bytes(tail[4:8], 'little')) & _M
    c = (c + int.from_bytes(tail[8:12], 'little')) & _M
    c ^= b; c = (c - _rot(b, 14)) & _M
    a ^= c; a = (a - _rot(c, 11)) & _M
    b ^= a; b = (b - _rot(a, 25)) & _M
    c ^= b; c = (c - _rot(b, 16)) & _M
    a ^= c; a = (a - _rot(c, 4)) & _M
    b ^= a; b = (b - _rot(a, 14)) & _M
    c ^= b; c = (c - _rot(b, 24)) & _M
    return c


# ------------------------------- datatypes ------------------------------- #

def _fixed_type(size, signed):
    bits = 0x08 if signed else 0x00          # little endian, zero padding
    return (bytes([0x10, bits, 0, 0]) + struct.pack('<I', size)
            + struct.pack('<HH', 0, 8 * size))


def _float_type(size):
    if size == 4:
        sign, eloc, esz, msz, bias = 31, 23, 8, 23, 127
    else:
        sign, eloc, esz, msz, bias = 63, 52, 11, 52, 1023
    # byte 0: little endian, implied-msb mantissa normalization (0x20)
    return (bytes([0x11, 0x20, sign, 0]) + struct.pack('<I', size)
            + struct.pack('<HHBBBBI', 0, 8 * size, eloc, esz, 0, msz, bias))


def _bool_type():
    base = _fixed_type(1, True)
    return (bytes([0x38, 2, 0, 0]) + struct.pack('<I', 1) + base
            + b'FALSE\x00TRUE\x00' + bytes([0, 1]))


def _datatype(dtype):
    dtype = np.dtype(dtype)
    if dtype == np.bool_:
        return _bool_type()
    if dtype.kind in 'iu' and dtype.itemsize in (1, 2, 4, 8):
        return _fixed_type(dtype.itemsize, dtype.kind == 'i')
    if dtype.kind == 'f' and dtype.itemsize in (4, 8):
        return _float_type(dtype.itemsize)
    raise TypeError(f'unsupported dtype {dtype}')


def _parse_datatype(buf):
    cls = buf[0] & 0x0F
    bits = buf[1]
    size = struct.unpack_from('<I', buf, 4)[0]
    if cls in (0, 1) and bits & 0x01:
        raise OSError('big-endian data is not supported')
    if cls == 0:
        return np.dtype(('i' if bits & 0x08 else 'u') + str(size)).newbyteorder('<')
    if cls == 1 and size in (4, 8):
        return np.dtype('<f' + str(size))
    if cls == 8:
        base = _parse_datatype(buf[8:])
        if base.itemsize == 1 and bytes(buf).find(b'FALSE\x00') >= 0:
            return np.dtype(np.bool_)
        return base
    raise OSError(f'unsupported HDF5 datatype class {cls}')


# ---------------------------- object headers ---------------------------- #

def _message(mtype, body):
    return struct.pack('<BHB', mtype, len(body), 0) + body


def _object_header(messages):
    body = b''.join(messages)
    head = b'OHDR' + bytes([2, 0x02]) + struct.pack('<I', len(body))
    blob = head + body
    return blob + struct.pack('<I', lookup3(blob))


class _Node:
    """In-memory tree written on close."""


class Dataset(_Node):
    def __init__(self, data):
        self._data = data

    def __getitem__(self, key):
        if key != ():
            raise NotImplementedError('only ds[()] reads are supported')
        return self._data[()] if self._data.ndim == 0 else self._data.copy()


class Group(_Node):
    def __init__(self):
        self._children = {}

    def _walk(self, name, create):
        node = self
        parts = [p for p in str(name).split('/') if p]
        for p in parts[:-1]:
            nxt = node._children.get(p)
            if nxt is None:
                if not create:
                    raise KeyError(name)
                nxt = node._children[p] = Group()
            if not isinstance(nxt, Group):
                raise KeyError(f'{p} is not a group')
            node = nxt
        return node, (parts[-1] if parts else None)

    def __getitem__(self, name):
        node, leaf = self._walk(name, False)
        if leaf is None:
            return node
        if leaf not in node._children:
            raise KeyError(name)
        return node._children[leaf]

    def __contains__(self, name):
        try:
            self[name]
        except KeyError:
            return False
        return True

    def keys(self):
        return sorted(self._children)

    def create_dataset(self, name, data, **kwargs):
        """``kwargs`` (h5py's compression options) are accepted and
        ignored: data is stored uncompressed."""
        node, leaf = self._walk(name, True)
        if leaf in node._children:
            raise ValueError(f'{name} exists')
        arr = np.asarray(data)
        _datatype(arr.dtype)                 # raise early on other dtypes
        arr = np.array(arr, order='C')       # keeps 0-d arrays 0-d
        if arr.dtype.byteorder == '>':
            arr = arr.astype(arr.dtype.newbyteorder('<'))
        ds = node._children[leaf] = Dataset(arr)
        return ds


class File(Group):
    def __init__(self, name, mode='r', **kwargs):
        super().__init__()
        self.filename = str(name)
        self.mode = mode
        self._open = True
        if mode == 'w':
            with open(self.filename, 'wb'):
                pass
        elif mode == 'r':
            with open(self.filename, 'rb') as f:
                self._read(f.read())
        else:
            raise NotImplementedError(f'mode {mode!r} is not supported')

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self):
        if not self._open:
            return
        self._open = False
        if self.mode != 'r':
            with open(self.filename, 'wb') as f:
                f.write(self._serialize())

    # ------------------------------ writing ------------------------------ #

    def _serialize(self):
        # pass 1: object-header sizes and addresses (sizes do not depend
        # on address values); pass 2: bytes
        order = []

        def visit(node):
            order.append(node)
            if isinstance(node, Group):
                for k in sorted(node._children):
                    visit(node._children[k])

        visit(self)
        addr = {}
        pos = 48
        for node in order:
            addr[id(node)] = pos
            pos += len(self._header(node, addr, dry=True))
            if isinstance(node, Dataset):
                pos += node._data.nbytes
        eof = pos
        out = bytearray()
        for node in order:
            out += self._header(node, addr)
            if isinstance(node, Dataset):
                out += node._data.tobytes()
        sb = (_SIG + bytes([2, 8, 8, 0])
              + struct.pack('<QQQQ', 0, _UNDEF, eof, addr[id(self)]))
        sb += struct.pack('<I', lookup3(sb))
        return bytes(sb) + bytes(out)

    @staticmethod
    def _header(node, addr, dry=False):
        if isinstance(node, Group):
            msgs = [_message(0x02, bytes([0, 0]) + struct.pack('<QQ', _UNDEF, _UNDEF)),
                    _message(0x0A, bytes([0, 0]))]
            for name in sorted(node._children):
                nb = name.encode('utf-8')
                if len(nb) > 255:
                    raise ValueError(f'link name too long: {name}')
                child = 0 if dry else addr[id(node._children[name])]
                msgs.append(_message(0x06, bytes([1, 0, len(nb)]) + nb
                                     + struct.pack('<Q', child)))
            return _object_header(msgs)
        arr = node._data
        if arr.ndim == 0:
            space = bytes([2, 0, 0, 0])
        else:
            space = bytes([2, arr.ndim, 0, 1]) + b''.join(
                struct.pack('<Q', d) for d in arr.shape)
        here = 0 if dry else addr[id(node)]
        msgs = [_message(0x01, space), _message(0x03, _datatype(arr.dtype)),
                _message(0x05, bytes([3, 0x0A]))]
        hdr_len = len(_object_header(msgs + [_message(0x08, bytes(18))]))
        data_addr = here + hdr_len if arr.nbytes else _UNDEF
        msgs.append(_message(0x08, bytes([3, 1])
                             + struct.pack('<QQ', data_addr, arr.nbytes)))
        return _object_header(msgs)

    # ------------------------------ reading ------------------------------ #

    def _read(self, buf):
        if buf[:8] != _SIG:
            raise OSError(f'{self.filename}: not an HDF5 file')
        if buf[8] not in (2, 3):
            raise OSError(f'{self.filename}: superblock version {buf[8]} is '
                          'not supported without h5py')
        root = struct.unpack_from('<Q', buf, 36)[0]
        self._children = self._read_object(buf, root)._children

    def _read_object(self, buf, at):
        if buf[at:at + 4] != b'OHDR':
            raise OSError(f'{self.filename}: unsupported object header at {at}')
        flags = buf[at + 5]
        p = at + 6
        if flags & 0x20:
            p += 16
        if flags & 0x10:
            p += 4
        width = 1 << (flags & 0x03)
        size = int.from_bytes(buf[p:p + width], 'little')
        p += width
        chunks = [(p, p + size)]
        msgs = {}
        links = {}
        while chunks:
            p, end = chunks.pop(0)
            while p + 4 <= end:
                mtype, msize, mflags = struct.unpack_from('<BHB', buf, p)
                p += 4
                if flags & 0x04:
                    p += 2
                body = buf[p:p + msize]
                p += msize
                if mtype == 0x06:
                    name, target = self._parse_link(body)
                    links[name] = target
                elif mtype == 0x10:
                    # continuation: an OCHK block of further messages
                    caddr, clen = struct.unpack_from('<QQ', body, 0)
                    if buf[caddr:caddr + 4] != b'OCHK':
                        raise OSError('bad object header continuation')
                    chunks.append((caddr + 4, caddr + clen - 4))
                elif mtype == 0x02 and struct.unpack_from('<Q', body, 2)[0] != _UNDEF:
                    raise OSError('dense link storage is not supported')
                elif mtype:
                    msgs[mtype] = body
        if 0x02 in msgs or 0x11 in msgs or links:
            if 0x11 in msgs:
                raise OSError('symbol-table groups are not supported')
            g = Group()
            for name, target in links.items():
                g._children[name] = self._read_object(buf, target)
            return g
        return Dataset(self._parse_data(buf, msgs))

    @staticmethod
    def _parse_link(body):
        flags = body[1]
        q = 2
        if flags & 0x08:
            if body[q] != 0:
                raise OSError('only hard links are supported')
            q += 1
        if flags & 0x04:
            q += 8
        if flags & 0x10:
            q += 1
        w = 1 << (flags & 0x03)
        n = int.from_bytes(body[q:q + w], 'little')
        q += w
        name = bytes(body[q:q + n]).decode('utf-8')
        return name, struct.unpack_from('<Q', body, q + n)[0]

    @staticmethod
    def _parse_data(buf, msgs):
        space = msgs[0x01]
        ver, rank, sflags = space[0], space[1], space[2]
        q = 4 if ver == 2 else 8
        shape = tuple(struct.unpack_from('<Q', space, q + 8 * i)[0]
                      for i in range(rank))
        if ver == 2 and space[3] == 2:
            shape = (0,)
        dtype = _parse_datatype(msgs[0x03])
        layout = msgs[0x08]
        if layout[0] not in (3, 4):
            raise OSError(f'data layout version {layout[0]} is not supported')
        count = int(np.prod(shape)) if shape else 1
        nbytes = count * dtype.itemsize
        if layout[1] == 1:
            daddr = struct.unpack_from('<Q', layout, 2)[0]
            raw = bytes(nbytes) if daddr == _UNDEF else buf[daddr:daddr + nbytes]
        elif layout[1] == 0:
            n = struct.unpack_from('<H', layout, 2)[0]
            raw = layout[4:4 + n]
        else:
            raise OSError('chunked (filtered) datasets are not supported')
        if 0x0B in msgs:
            raise OSError('filtered datasets are not supported')
        if dtype == np.bool_:
            arr = np.frombuffer(bytes(raw), dtype=np.int8).astype(np.bool_)
        else:
            arr = np.frombuffer(bytes(raw), dtype=dtype).copy()
        return arr.reshape(shape) if shape else arr.reshape(())
