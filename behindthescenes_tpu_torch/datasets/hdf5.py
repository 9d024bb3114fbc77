"""A read-only HDF5 reader in numpy and the standard library (no JAX
counterpart: the JAX package reads NYU Depth v2's MATLAB v7.3 `.mat`,
which is HDF5, through h5py, and the GPU machine has no h5py).

It reads the subset that h5py and MATLAB v7.3 write:
- the superblock at offset 0, 512, 1024, 2048, ... (MATLAB writes a
  512-byte user block first), versions 0, 1, 2 and 3;
- object headers of versions 1 and 2, with continuation blocks;
- groups by symbol table (a version-1 group B-tree, its local heap and
  symbol table nodes) and by link messages (compact storage; hard links);
- the dataspace, and fixed-point and IEEE floating-point datatypes in
  either byte order;
- the compact, contiguous and chunked layouts (data layout message
  versions 3 and 4; chunks indexed by a version-1 B-tree), edge chunks
  included;
- the deflate and shuffle filters.
Anything else (another filter, a reference or string datatype, dense
link storage, another chunk index, a soft link, an unwritten chunk, a
committed datatype) raises NotImplementedError naming the feature and
the file. There is no fallback to h5py.

`File(path)["name"]` is a `Group` or a `Dataset`; `Dataset[i]` with an
integer or a slice along axis 0 reads only the bytes (contiguous) or the
chunks (chunked) that hold those indices, and `Dataset[()]` the whole
array. Arrays keep the file's byte order, as h5py's do. Reads use
`os.pread`, so several threads may read one file.
"""
from __future__ import annotations

import math
import os
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
# Object header message types.
_DATASPACE, _LINK_INFO, _DATATYPE, _LINK = 0x1, 0x2, 0x3, 0x6
_LAYOUT, _FILTERS, _CONTINUATION, _SYMBOL_TABLE = 0x8, 0xB, 0x10, 0x11
_DEFLATE, _SHUFFLE = 1, 2


class _Reader:
    """Little-endian fields of an HDF5 file at absolute offsets."""

    def __init__(self, path):
        self.path = str(path)
        self.fd = os.open(self.path, os.O_RDONLY)
        self.size = os.fstat(self.fd).st_size
        self.base = 0
        self.so = self.sl = 8         # sizes of offsets and lengths

    def close(self):
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def unsupported(self, what: str):
        return NotImplementedError(f"{self.path}: {what} is not supported "
                                   "by this HDF5 reader")

    def read(self, offset: int, n: int) -> bytes:
        data = os.pread(self.fd, n, offset)
        if len(data) != n:
            raise ValueError(f"{self.path}: {n} bytes at {offset} run past "
                             "the end of the file")
        return data

    def undefined(self, addr: int, size: int) -> bool:
        return addr == (1 << (8 * size)) - 1

    def address(self, addr: int) -> int:
        """A file address made absolute (the base address added)."""
        return self.base + addr


def _uint(buf: bytes, pos: int, size: int) -> int:
    return int.from_bytes(buf[pos:pos + size], "little")


def _find_superblock(r: _Reader) -> int:
    pos = 0
    while pos + 8 <= r.size:
        if r.read(pos, 8) == _SIGNATURE:
            return pos
        pos = 512 if pos == 0 else 2 * pos
    raise ValueError(f"{r.path}: no HDF5 superblock")


def _open_superblock(r: _Reader) -> int:
    """Reads the superblock; returns the root group's object header
    address (absolute)."""
    at = _find_superblock(r)
    head = r.read(at, 64)
    version = head[8]
    if version in (0, 1):
        r.so, r.sl = head[13], head[14]
        pos = 24 + (4 if version == 1 else 0)
        buf = r.read(at + pos, 4 * r.so + 2 * r.so + 24)
        r.base = _uint(buf, 0, r.so)
        entry = 4 * r.so                       # the root symbol table entry
        root = _uint(buf, entry + r.so, r.so)
    elif version in (2, 3):
        r.so, r.sl = head[9], head[10]
        buf = r.read(at + 12, 4 * r.so)
        r.base = _uint(buf, 0, r.so)
        root = _uint(buf, 3 * r.so, r.so)
    else:
        raise r.unsupported(f"superblock version {version}")
    return r.address(root)


def _messages(r: _Reader, addr: int) -> list:
    """[(type, flags, body)] of the object header at `addr`, continuation
    blocks followed."""
    out, blocks = [], []
    head = r.read(addr, 16)
    if head[:4] == b"OHDR":
        if head[4] != 2:
            raise r.unsupported(f"object header version {head[4]}")
        flags, pos = head[5], 6
        if flags & 0x20:
            pos += 16
        if flags & 0x10:
            pos += 4
        width = 1 << (flags & 3)
        size = _uint(r.read(addr + pos, width), 0, width)
        blocks.append((addr + pos + width, size, 2, flags))
    elif head[0] == 1:
        blocks.append((addr + 16, _uint(head, 8, 4), 1, 0))
    else:
        raise r.unsupported(f"object header at {addr} (version {head[0]})")
    while blocks:
        start, size, version, flags = blocks.pop(0)
        buf = r.read(start, size)
        pos = 0
        if version == 2 and buf[:4] == b"OCHK":
            pos, size = 4, size - 4             # its checksum at the end
        hsize = 8 if version == 1 else 4 + (2 if flags & 4 else 0)
        while pos + hsize <= size:
            if version == 1:
                mtype, msize = _uint(buf, pos, 2), _uint(buf, pos + 2, 2)
                mflags = buf[pos + 4]
            else:
                mtype, msize, mflags = buf[pos], _uint(buf, pos + 1, 2), \
                    buf[pos + 3]
            body = buf[pos + hsize:pos + hsize + msize]
            pos += hsize + msize
            if mtype == _CONTINUATION:
                cont = r.address(_uint(body, 0, r.so))
                length = _uint(body, r.so, r.sl)
                blocks.append((cont, length, version, flags))
            elif mtype:
                out.append((mtype, mflags, body))
    return out


def _symbol_table_links(r: _Reader, btree: int, heap: int) -> dict:
    """{name: object header address} of a group's version-1 B-tree and
    local heap."""
    hbuf = r.read(heap, 8 + 2 * r.sl + r.so)
    if hbuf[:4] != b"HEAP":
        raise ValueError(f"{r.path}: no local heap at {heap}")
    seg_size = _uint(hbuf, 8, r.sl)
    segment = r.read(r.address(_uint(hbuf, 8 + 2 * r.sl, r.so)), seg_size)
    links, nodes = {}, [btree]
    while nodes:
        node = nodes.pop()
        head = r.read(node, 8 + 2 * r.so)
        if head[:4] == b"SNOD":
            count = _uint(head, 6, 2)
            entry = 2 * r.so + 24
            buf = r.read(node + 8, count * entry)
            for i in range(count):
                name_off = _uint(buf, i * entry, r.so)
                name = segment[name_off:segment.index(b"\0", name_off)]
                soft = _uint(buf, i * entry + 2 * r.so, 4) == 2
                links[name.decode()] = None if soft else r.address(
                    _uint(buf, i * entry + r.so, r.so))
            continue
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"{r.path}: no group B-tree node at {node}")
        count = _uint(head, 6, 2)
        step = r.sl + r.so      # key, child, ..., key: children between
        children = r.read(node + 8 + 2 * r.so, count * step + r.sl)
        nodes += [r.address(_uint(children, r.sl + i * step, r.so))
                  for i in range(count)]
    return links


def _link_message(r: _Reader, body: bytes):
    """(name, object header address) of a hard link message."""
    if body[0] != 1:
        raise r.unsupported(f"link message version {body[0]}")
    flags, pos = body[1], 2
    kind = 0
    if flags & 0x8:
        kind, pos = body[pos], pos + 1
    if flags & 0x4:
        pos += 8
    if flags & 0x10:
        pos += 1
    width = 1 << (flags & 3)
    length, pos = _uint(body, pos, width), pos + width
    name = body[pos:pos + length].decode()
    if kind != 0:
        raise r.unsupported(f"link {name!r} of type {kind} (soft or "
                            "external)")
    return name, r.address(_uint(body, pos + length, r.so))


def _dataspace(r: _Reader, body: bytes) -> tuple:
    version, rank = body[0], body[1]
    if version == 1:
        pos = 8
    elif version == 2:
        if body[3] == 2:
            raise r.unsupported("a null dataspace")
        pos = 4
    else:
        raise r.unsupported(f"dataspace version {version}")
    return tuple(_uint(body, pos + i * r.sl, r.sl) for i in range(rank))


def _datatype(r: _Reader, body: bytes) -> np.dtype:
    cls, bits = body[0] & 0xF, _uint(body, 1, 3)
    size = _uint(body, 4, 4)
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = _uint(body, 8, 2), _uint(body, 10, 2)
        if offset or precision != 8 * size or size not in (1, 2, 4, 8):
            raise r.unsupported(f"an integer of {precision} bits at bit "
                                f"{offset} in {size} bytes")
        return np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}")
    if cls == 1:
        layout = {2: (10, 5, 0, 10), 4: (23, 8, 0, 23),
                  8: (52, 11, 0, 52)}.get(size)
        got = (body[12], body[13], body[14], body[15]) if size else None
        if bits & 0x40 or layout is None or got != layout:
            raise r.unsupported(f"a floating-point type of {size} bytes "
                                f"that is not IEEE ({got})")
        return np.dtype(f"{order}f{size}")
    names = {2: "a time", 3: "a string", 4: "a bitfield", 5: "an opaque",
             6: "a compound", 7: "a reference", 8: "an enumerated",
             9: "a variable-length", 10: "an array"}
    raise r.unsupported(f"{names.get(cls, f'class {cls}')} datatype")


def _filters(r: _Reader, body: bytes) -> list:
    """The pipeline's filter ids, in the order they were applied."""
    version, count = body[0], body[1]
    pos = 8 if version == 1 else 2
    out = []
    for _ in range(count):
        fid = _uint(body, pos, 2)
        name_len = 0 if version == 2 and fid < 256 else _uint(body,
                                                             pos + 2, 2)
        pos += 2 if version == 2 and fid < 256 else 4
        n_values = _uint(body, pos + 2, 2)
        pos += 4
        if version == 1:
            pos += (name_len + 7) // 8 * 8
            pos += 4 * (n_values + (n_values & 1))
        else:
            pos += name_len + 4 * n_values
        if fid not in (_DEFLATE, _SHUFFLE):
            raise r.unsupported(f"filter {fid}")
        out.append(fid)
    return out


def _unfilter(data: bytes, filters: list, mask: int, itemsize: int,
              r: _Reader) -> bytes:
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        if filters[i] == _DEFLATE:
            data = zlib.decompress(data)
        else:                               # shuffle: byte planes
            n = len(data) // itemsize
            planes = np.frombuffer(data, np.uint8, n * itemsize)
            data = planes.reshape(itemsize, n).T.tobytes() \
                + data[n * itemsize:]
    return data


class Dataset:
    """An HDF5 dataset: `shape`, `dtype`, `ds[i]` / `ds[a:b]` along axis 0
    and `ds[()]`."""

    def __init__(self, r: _Reader, name: str, messages: list):
        self._r, self.name = r, name
        found = {}
        for mtype, mflags, body in messages:
            if mtype in (_DATASPACE, _DATATYPE, _LAYOUT, _FILTERS):
                if mflags & 2:
                    raise r.unsupported(f"a shared message (type {mtype}) "
                                        f"in {name}")
                found[mtype] = body
        self.shape = _dataspace(r, found[_DATASPACE])
        self.dtype = _datatype(r, found[_DATATYPE])
        self._filters = _filters(r, found[_FILTERS]) \
            if _FILTERS in found else []
        self._layout(found[_LAYOUT])
        self._chunk_index = None

    def _layout(self, body: bytes):
        r = self._r
        version, cls = body[0], body[1]
        if version not in (3, 4):
            raise r.unsupported(f"data layout version {version}")
        if cls == 0:
            size = _uint(body, 2, 2)
            self._kind, self._compact = "compact", body[4:4 + size]
        elif cls == 1:
            self._kind = "contiguous"
            self._addr = _uint(body, 2, r.so)
        elif cls == 2 and version == 3:
            rank = body[2]
            self._kind = "chunked"
            self._addr = r.address(_uint(body, 3, r.so))
            self._chunk = tuple(_uint(body, 3 + r.so + 4 * i, 4)
                                for i in range(rank - 1))
        elif cls == 2:
            raise r.unsupported(f"chunk index type {self._v4_index(body)} "
                                f"of {self.name} (only the version-1 "
                                "B-tree of layout version 3)")
        else:
            raise r.unsupported(f"data layout class {cls}")
        if self._filters and self._kind != "chunked":
            raise r.unsupported(f"filters on a {self._kind} dataset")

    @staticmethod
    def _v4_index(body: bytes) -> int:
        rank, width = body[3], body[4]
        return body[5 + rank * width]

    def __getitem__(self, index):
        if isinstance(index, tuple) and not index:
            return self._rows(0, self.shape[0]) if self.shape \
                else self._rows(0, 1).reshape(())
        if isinstance(index, (int, np.integer)):
            i = int(index) + (self.shape[0] if index < 0 else 0)
            if not 0 <= i < self.shape[0]:
                raise IndexError(f"index {index} of {self.shape[0]}")
            return self._rows(i, i + 1)[0]
        if isinstance(index, slice) and index.step in (None, 1):
            start, stop, _ = index.indices(self.shape[0])
            return self._rows(start, max(start, stop))
        raise TypeError(f"{self.name}: index with an integer or a slice of "
                        "axis 0, or ()")

    def _rows(self, start: int, stop: int) -> np.ndarray:
        rest = self.shape[1:]
        if self._kind == "compact":
            full = np.frombuffer(self._compact, self.dtype,
                                 math.prod(self.shape))
            return full.reshape(self.shape or (1,))[start:stop].copy()
        if self._kind == "contiguous":
            row = math.prod(rest) * self.dtype.itemsize
            n = max(stop - start, 0)
            if self._r.undefined(self._addr, self._r.so):
                raise self._r.unsupported(f"unwritten data of {self.name}")
            data = self._r.read(self._r.address(self._addr) + start * row,
                                n * row)
            return np.frombuffer(bytearray(data), self.dtype) \
                .reshape((n,) + rest)
        return self._chunked_rows(start, stop)

    def _chunks(self) -> list:
        """[(chunk offset tuple, stored size, filter mask, address)] from
        the version-1 chunk B-tree."""
        if self._chunk_index is not None:
            return self._chunk_index
        r, rank = self._r, len(self.shape)
        key = 8 + 8 * (rank + 1)
        out, nodes = [], [self._addr]
        while nodes:
            node = nodes.pop()
            head = r.read(node, 8 + 2 * r.so)
            if head[:4] != b"TREE" or head[4] != 1:
                raise ValueError(f"{r.path}: no chunk B-tree node at {node}")
            level, count = head[5], _uint(head, 6, 2)
            buf = r.read(node + 8 + 2 * r.so, count * (key + r.so) + key)
            for i in range(count):
                pos = i * (key + r.so)
                child = r.address(_uint(buf, pos + key, r.so))
                if level:
                    nodes.append(child)
                    continue
                offsets = tuple(_uint(buf, pos + 8 + 8 * d, 8)
                                for d in range(rank))
                out.append((offsets, _uint(buf, pos, 4),
                            _uint(buf, pos + 4, 4), child))
        self._chunk_index = out
        return out

    def _chunked_rows(self, start: int, stop: int) -> np.ndarray:
        n = max(stop - start, 0)
        out = np.empty((n,) + self.shape[1:], self.dtype)
        filled = np.zeros(n, np.int64)
        c0 = self._chunk[0]
        per_row = math.prod(self.shape[1:])
        for offsets, size, mask, addr in self._chunks():
            lo, hi = max(offsets[0], start), min(offsets[0] + c0, stop)
            if lo >= hi:
                continue
            data = _unfilter(self._r.read(addr, size), self._filters, mask,
                             self.dtype.itemsize, self._r)
            block = np.frombuffer(data, self.dtype,
                                  math.prod(self._chunk)).reshape(self._chunk)
            src = [slice(lo - offsets[0], hi - offsets[0])]
            dst = [slice(lo - start, hi - start)]
            for o, c, s in zip(offsets[1:], self._chunk[1:], self.shape[1:]):
                src.append(slice(0, min(c, s - o)))
                dst.append(slice(o, min(o + c, s)))
            out[tuple(dst)] = block[tuple(src)]
            filled[lo - start:hi - start] += math.prod(
                d.stop - d.start for d in dst[1:])
        if (filled != per_row).any():
            raise self._r.unsupported(f"unwritten chunks of {self.name}")
        return out


class Group:
    """An HDF5 group: `group["a/b"]`, `keys()`, `in`."""

    def __init__(self, r: _Reader, name: str, messages: list):
        self._r, self.name = r, name
        self._links = {}
        for mtype, _, body in messages:
            if mtype == _SYMBOL_TABLE:
                self._links.update(_symbol_table_links(
                    r, r.address(_uint(body, 0, r.so)),
                    r.address(_uint(body, r.so, r.so))))
            elif mtype == _LINK:
                link, addr = _link_message(r, body)
                self._links[link] = addr
            elif mtype == _LINK_INFO:
                pos = 2 + (8 if body[1] & 1 else 0)
                if not r.undefined(_uint(body, pos, r.so), r.so):
                    raise r.unsupported(f"dense link storage in {name}")

    def keys(self):
        return list(self._links)

    def __contains__(self, key):
        return key in self._links

    def __getitem__(self, key: str):
        node = self
        for part in [p for p in key.split("/") if p]:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(f"{self._r.path}: no object {key!r}")
            addr = node._links[part]
            if addr is None:
                raise self._r.unsupported(f"the soft link {key!r}")
            node = _object(node._r, f"{node.name.rstrip('/')}/{part}", addr)
        return node


def _object(r: _Reader, name: str, addr: int):
    messages = _messages(r, addr)
    types = {m[0] for m in messages}
    if _LAYOUT in types:
        return Dataset(r, name, messages)
    if types & {_SYMBOL_TABLE, _LINK, _LINK_INFO}:
        return Group(r, name, messages)
    raise r.unsupported(f"the object {name} (a committed datatype?)")


class File(Group):
    """An HDF5 file opened for reading: the root group; close() (or a
    `with` block) closes it."""

    def __init__(self, path):
        r = _Reader(path)
        try:
            root = _open_superblock(r)
            super().__init__(r, "/", _messages(r, root))
        except BaseException:
            r.close()
            raise

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

