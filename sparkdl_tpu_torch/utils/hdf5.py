"""A read-only HDF5 reader in numpy, and a minimal writer, for Keras files.

The port reads ``.keras`` and legacy ``.h5`` Keras files on a machine that
has neither Keras nor ``h5py``. This module reads what ``h5py`` writes by
default (the JAX package needs no such module: it has ``h5py``):

- superblock versions 0 and 1 (and 2 and 3, whose groups must then keep
  their links in the object header);
- version-1 object headers (8-byte aligned messages) and version-2 ones,
  with continuation messages;
- groups as symbol tables: a version-1 B-tree of group nodes of any depth,
  its ``SNOD`` leaves and the local heap of names; and groups as link
  messages;
- the dataspace, datatype, data layout (contiguous and compact) and
  attribute messages;
- fixed-point and IEEE float data (f16, f32, f64), fixed-length strings and
  variable-length strings (through the global heap), empty datasets and
  scalar dataspaces.

A dataset reads as an ``np.frombuffer`` view of the file's bytes in the
file's byte order. Chunked or filtered layouts, external files, dense link
or attribute storage and other datatypes raise ``NotImplementedError``
naming the object: Keras never writes them, but a user's file could hold
them.

:func:`write` makes a file of groups, contiguous datasets and string
attributes, scalar or 1-d (superblock 0, version-1 headers, symbol-table
groups): enough to write a Keras weights file, ``.keras`` or legacy ``.h5``,
without ``h5py``.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
_DATASPACE = 0x01
_LINK_INFO = 0x02
_DATATYPE = 0x03
_LINK = 0x06
_EXTERNAL = 0x07
_LAYOUT = 0x08
_FILTERS = 0x0B
_ATTRIBUTE = 0x0C
_CONTINUATION = 0x10
_SYMBOL_TABLE = 0x11
_ATTRIBUTE_INFO = 0x15

Source = Union[str, os.PathLike, bytes, bytearray, memoryview]


class _VlenString:
    """The datatype of variable-length strings: each element is (length,
    global heap collection address, object index)."""

    def __init__(self, size: int, charset: int):
        self.itemsize = size
        self.charset = charset


class _FixedString:
    def __init__(self, size: int, charset: int):
        self.itemsize = size
        self.dtype = np.dtype(f"S{size}")
        self.charset = charset


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Reader:
    """The file's bytes and the decoding shared by every object."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self._gheaps: Dict[int, Dict[int, memoryview]] = {}
        base = self._find_superblock()
        version = buf[base + 8]
        if version in (0, 1):
            self.offsets, self.lengths = buf[base + 13], buf[base + 14]
            pos = base + 24 + (4 if version == 1 else 0)
            self.base = self._uint(pos, self.offsets)
            # base, free space, end of file, driver info, root entry
            root_entry = pos + 4 * self.offsets
            self.root = self._uint(root_entry + self.offsets, self.offsets)
        elif version in (2, 3):
            self.offsets, self.lengths = buf[base + 9], buf[base + 10]
            pos = base + 12
            self.base = self._uint(pos, self.offsets)
            self.root = self._uint(pos + 3 * self.offsets, self.offsets)
        else:
            raise NotImplementedError(f"HDF5 superblock version {version}")
        if self.base != base and self.base != 0:
            raise NotImplementedError(f"HDF5 base address {self.base}")
        self.base = base

    def _find_superblock(self) -> int:
        pos = 0
        while pos + 8 <= len(self.buf):
            if bytes(self.buf[pos:pos + 8]) == _SIGNATURE:
                return pos
            pos = 512 if pos == 0 else pos * 2
        raise ValueError("not an HDF5 file: no superblock signature")

    # -- primitives -----------------------------------------------------
    def _uint(self, pos: int, size: int) -> int:
        return int.from_bytes(self.buf[pos:pos + size], "little")

    def addr(self, pos: int) -> int:
        return self._uint(pos, self.offsets)

    def length(self, pos: int) -> int:
        return self._uint(pos, self.lengths)

    def at(self, address: int) -> int:
        """A file address as an offset into the buffer."""
        if self._is_undefined(address):
            raise ValueError("undefined HDF5 address")
        return self.base + address

    def _is_undefined(self, address: int) -> bool:
        return address == (1 << (8 * self.offsets)) - 1

    # -- object headers -------------------------------------------------
    def messages(self, address: int) -> List[Tuple[int, int, int]]:
        """(type, offset of its data, size) of each message of the object
        header at ``address``, continuation blocks followed."""
        pos = self.at(address)
        if bytes(self.buf[pos:pos + 4]) == b"OHDR":
            return self._messages_v2(pos)
        if self.buf[pos] != 1:
            raise NotImplementedError(f"HDF5 object header version {self.buf[pos]}")
        size = self._uint(pos + 8, 4)
        out: List[Tuple[int, int, int]] = []
        blocks = [(pos + 16, size)]
        while blocks:
            start, size = blocks.pop(0)
            p, end = start, start + size
            while p + 8 <= end:
                mtype, msize = self._uint(p, 2), self._uint(p + 2, 2)
                if mtype == _CONTINUATION:
                    blocks.append((self.at(self.addr(p + 8)), self.length(p + 8 + self.offsets)))
                elif mtype:
                    out.append((mtype, p + 8, msize))
                p += 8 + msize
        return out

    def _messages_v2(self, pos: int) -> List[Tuple[int, int, int]]:
        flags = self.buf[pos + 5]
        p = pos + 6
        if flags & 0x20:
            p += 16
        if flags & 0x10:
            p += 4
        width = 1 << (flags & 3)
        size = self._uint(p, width)
        p += width
        header = 6 if flags & 0x04 else 4
        out: List[Tuple[int, int, int]] = []
        blocks = [(p, size)]
        while blocks:
            start, size = blocks.pop(0)
            q, end = start, start + size
            while q + header <= end:
                mtype, msize = self.buf[q], self._uint(q + 1, 2)
                data = q + header
                if mtype == _CONTINUATION:
                    cont = self.at(self.addr(data))
                    clen = self.length(data + self.offsets)
                    if bytes(self.buf[cont:cont + 4]) != b"OCHK":
                        raise ValueError("bad HDF5 continuation block")
                    blocks.append((cont + 4, clen - 8))
                elif mtype:
                    out.append((mtype, data, msize))
                q = data + msize
        return out

    # -- groups ---------------------------------------------------------
    def links(self, address: int, msgs, name: str) -> Dict[str, int]:
        """Child name -> object header address of the group at ``address``."""
        children: Dict[str, int] = {}
        for mtype, pos, _ in msgs:
            if mtype == _SYMBOL_TABLE:
                btree, heap = self.addr(pos), self.addr(pos + self.offsets)
                names = self._local_heap(heap)
                self._walk_group_btree(btree, names, children)
            elif mtype == _LINK:
                self._link(pos, children, name)
            elif mtype == _LINK_INFO:
                heap_pos = pos + 2 + (8 if self.buf[pos + 1] & 1 else 0)
                if not self._is_undefined(self.addr(heap_pos)):
                    raise NotImplementedError(
                        f"group {name!r} keeps its links in dense storage (a fractal heap)")
        return children

    def _local_heap(self, address: int) -> memoryview:
        pos = self.at(address)
        if bytes(self.buf[pos:pos + 4]) != b"HEAP":
            raise ValueError("bad HDF5 local heap")
        size = self.length(pos + 8)
        data = self.at(self.addr(pos + 8 + 2 * self.lengths))
        return self.buf[data:data + size]

    @staticmethod
    def _cstring(heap: memoryview, offset: int) -> str:
        end = bytes(heap[offset:]).index(b"\0")
        return bytes(heap[offset:offset + end]).decode("utf-8")

    def _walk_group_btree(self, address: int, names: memoryview,
                          children: Dict[str, int]) -> None:
        pos = self.at(address)
        if bytes(self.buf[pos:pos + 4]) != b"TREE" or self.buf[pos + 4] != 0:
            raise ValueError("bad HDF5 group B-tree node")
        level = self.buf[pos + 5]
        used = self._uint(pos + 6, 2)
        p = pos + 8 + 2 * self.offsets + self.lengths  # past the first key
        for _ in range(used):
            child = self.addr(p)
            if level:
                self._walk_group_btree(child, names, children)
            else:
                self._symbol_node(child, names, children)
            p += self.offsets + self.lengths

    def _symbol_node(self, address: int, names: memoryview,
                     children: Dict[str, int]) -> None:
        pos = self.at(address)
        if bytes(self.buf[pos:pos + 4]) != b"SNOD":
            raise ValueError("bad HDF5 symbol table node")
        count = self._uint(pos + 6, 2)
        entry = 2 * self.offsets + 24
        for i in range(count):
            p = pos + 8 + i * entry
            children[self._cstring(names, self.length(p))] = self.addr(p + self.offsets)

    def _link(self, pos: int, children: Dict[str, int], group: str) -> None:
        flags = self.buf[pos + 1]
        p = pos + 2
        kind = 0
        if flags & 0x08:
            kind = self.buf[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        width = 1 << (flags & 3)
        size = self._uint(p, width)
        p += width
        name = bytes(self.buf[p:p + size]).decode("utf-8")
        if kind != 0:
            raise NotImplementedError(f"link {name!r} of group {group!r} is not a hard link")
        children[name] = self.addr(p + size)

    # -- datatypes, dataspaces, data ------------------------------------
    def datatype(self, pos: int, what: str):
        cls, version = self.buf[pos] & 0x0F, self.buf[pos] >> 4
        bits = self._uint(pos + 1, 3)
        size = self._uint(pos + 4, 4)
        order = ">" if bits & 1 else "<"
        if cls == 0:
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1 and size in (2, 4, 8):
            return np.dtype(f"{order}f{size}")
        if cls == 3:
            return _FixedString(size, (bits >> 4) & 0x0F)
        if cls == 9 and bits & 0x0F == 1:
            return _VlenString(size, (bits >> 8) & 0x0F)
        raise NotImplementedError(
            f"{what}: HDF5 datatype class {cls} (version {version}, size {size})")

    def dataspace(self, pos: int) -> Optional[Tuple[int, ...]]:
        """The shape (``()`` for a scalar), or None for a null dataspace."""
        version, rank, flags = self.buf[pos], self.buf[pos + 1], self.buf[pos + 2]
        if version == 1:
            start = pos + 8
        elif version == 2:
            if self.buf[pos + 3] == 2:
                return None
            start = pos + 4
        else:
            raise NotImplementedError(f"HDF5 dataspace version {version}")
        return tuple(self.length(start + i * self.lengths) for i in range(rank))

    def global_heap_object(self, address: int, index: int) -> memoryview:
        objects = self._gheaps.get(address)
        if objects is None:
            objects = self._gheaps[address] = self._global_heap(address)
        return objects[index]

    def _global_heap(self, address: int) -> Dict[int, memoryview]:
        pos = self.at(address)
        if bytes(self.buf[pos:pos + 4]) != b"GCOL":
            raise ValueError("bad HDF5 global heap collection")
        end = pos + self.length(pos + 8)
        p = pos + 8 + self.lengths
        objects: Dict[int, memoryview] = {}
        while p + 8 + self.lengths <= end:
            index = self._uint(p, 2)
            size = self.length(p + 8)
            if index == 0:
                break
            data = p + 8 + self.lengths
            objects[index] = self.buf[data:data + size]
            p = data + _pad8(size)
        return objects

    def values(self, dtype, shape: Optional[Tuple[int, ...]], data: Optional[int],
               what: str, as_str: bool = True) -> np.ndarray:
        """The elements at buffer offset ``data`` (None: never written, so
        zeros) as an array of ``shape``; variable-length strings as ``str``
        (``as_str``, as ``h5py`` reads attributes) or ``bytes`` (as it reads
        datasets)."""
        if shape is None:
            shape = (0,)
        count = int(np.prod(shape, dtype=np.int64))
        if isinstance(dtype, _VlenString):
            out = np.empty(count, dtype=object)
            for i in range(count):
                if data is None:
                    out[i] = ""
                    continue
                p = data + i * dtype.itemsize
                n = self._uint(p, 4)
                heap, index = self.addr(p + 4), self._uint(p + 4 + self.offsets, 4)
                raw = b"" if n == 0 or index == 0 else bytes(
                    self.global_heap_object(heap, index)[:n])
                out[i] = raw.decode("utf-8" if dtype.charset else "ascii") if as_str else raw
            return out.reshape(shape)
        np_dtype = dtype.dtype if isinstance(dtype, _FixedString) else dtype
        if data is None or count == 0:
            return np.zeros(shape, dtype=np_dtype)
        nbytes = count * np_dtype.itemsize
        if data + nbytes > len(self.buf):
            raise ValueError(f"{what}: its data runs past the end of the file")
        return np.frombuffer(self.buf, dtype=np_dtype, count=count, offset=data).reshape(shape)


def _scalar_or_array(values: np.ndarray, shape):
    """An attribute's value as ``h5py`` gives it: a scalar dataspace as a
    scalar (``str`` for variable-length strings), anything else as an
    array."""
    if shape == ():
        return values[()]
    return values


class Attributes(Mapping):
    """An object's attributes, decoded when read."""

    def __init__(self, reader: _Reader, msgs, owner: str):
        self._reader = reader
        self._owner = owner
        self._dense = False
        self._raw: Dict[str, Tuple[int, int]] = {}
        for mtype, pos, size in msgs:
            if mtype == _ATTRIBUTE:
                self._raw[self._name(pos)] = (pos, size)
            elif mtype == _ATTRIBUTE_INFO:
                flags = reader.buf[pos + 1]
                heap = reader.addr(pos + 2 + (2 if flags & 1 else 0))
                if not reader._is_undefined(heap):
                    self._dense = True

    def _name(self, pos: int) -> str:
        buf = self._reader.buf
        version = buf[pos]
        size = int.from_bytes(buf[pos + 2:pos + 4], "little")
        start = pos + (9 if version == 3 else 8)
        return bytes(buf[start:start + size]).rstrip(b"\0").decode("utf-8")

    def _check_dense(self):
        if self._dense:
            raise NotImplementedError(
                f"{self._owner!r} keeps its attributes in dense storage (a fractal heap)")

    def __getitem__(self, name: str):
        self._check_dense()
        if name not in self._raw:
            raise KeyError(f"no attribute {name!r} on {self._owner!r}")
        pos, _ = self._raw[name]
        reader, buf = self._reader, self._reader.buf
        version, flags = buf[pos], buf[pos + 1]
        if flags & 0x03:
            raise NotImplementedError(f"attribute {name!r} of {self._owner!r} is shared")
        name_size, type_size, space_size = (
            int.from_bytes(buf[pos + i:pos + i + 2], "little") for i in (2, 4, 6))
        what = f"attribute {name!r} of {self._owner!r}"
        if version == 1:
            p = pos + 8 + _pad8(name_size)
            dtype = reader.datatype(p, what)
            p += _pad8(type_size)
            shape = reader.dataspace(p)
            p += _pad8(space_size)
        elif version in (2, 3):
            p = pos + (9 if version == 3 else 8) + name_size
            dtype = reader.datatype(p, what)
            shape = reader.dataspace(p + type_size)
            p += type_size + space_size
        else:
            raise NotImplementedError(f"{what}: attribute message version {version}")
        return _scalar_or_array(reader.values(dtype, shape, p, what), shape)

    def __iter__(self) -> Iterator[str]:
        self._check_dense()
        return iter(self._raw)

    def __len__(self) -> int:
        self._check_dense()
        return len(self._raw)


class _Object:
    def __init__(self, reader: _Reader, address: int, name: str, msgs=None):
        self._reader = reader
        self._address = address
        self.name = name
        self._msgs = reader.messages(address) if msgs is None else msgs
        self.attrs = Attributes(reader, self._msgs, name)


class Dataset(_Object):
    """A dataset: ``shape``, ``dtype``, ``attrs``; ``read()`` gives its
    values."""

    def __init__(self, reader, address, name, msgs=None):
        super().__init__(reader, address, name, msgs)
        kinds = {m[0]: m for m in self._msgs}
        for bad, why in ((_FILTERS, "a filter pipeline (compression)"),
                         (_EXTERNAL, "external data files")):
            if bad in kinds:
                raise NotImplementedError(f"dataset {name!r} uses {why}")
        self._dtype = reader.datatype(kinds[_DATATYPE][1], f"dataset {name!r}")
        self.shape = reader.dataspace(kinds[_DATASPACE][1])
        self._data = self._layout(kinds[_LAYOUT][1])

    def _layout(self, pos: int) -> Optional[int]:
        reader, buf = self._reader, self._reader.buf
        version = buf[pos]
        if version in (1, 2):
            rank, cls = buf[pos + 1], buf[pos + 2]
            p = pos + 8
            if cls == 1:
                address = reader.addr(p)
                return None if reader._is_undefined(address) else reader.at(address)
            if cls == 0:
                return p + 4 * rank + 4
        elif version in (3, 4):
            cls = buf[pos + 1]
            if cls == 1:
                address = reader.addr(pos + 2)
                return None if reader._is_undefined(address) else reader.at(address)
            if cls == 0:
                return pos + 4
        else:
            raise NotImplementedError(f"dataset {self.name!r}: layout version {version}")
        kind = {2: "chunked", 3: "virtual"}.get(cls, f"class {cls}")
        raise NotImplementedError(f"dataset {self.name!r} has a {kind} layout")

    @property
    def dtype(self) -> np.dtype:
        if isinstance(self._dtype, _VlenString):
            return np.dtype(object)
        if isinstance(self._dtype, _FixedString):
            return self._dtype.dtype
        return self._dtype

    def read(self) -> np.ndarray:
        return self._reader.values(self._dtype, self.shape, self._data,
                                   f"dataset {self.name!r}", as_str=False)

    def __repr__(self):
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self.dtype}>"


class Group(_Object):
    """A group: a mapping of child names to groups and datasets; ``attrs``.
    ``group["a/b"]`` walks a path."""

    def __init__(self, reader, address, name, msgs=None):
        super().__init__(reader, address, name, msgs)
        self._links = reader.links(address, self._msgs, name)

    def _child(self, key: str):
        address = self._links[key]
        path = f"{self.name.rstrip('/')}/{key}"
        msgs = self._reader.messages(address)
        kinds = {m[0] for m in msgs}
        if kinds & {_SYMBOL_TABLE, _LINK, _LINK_INFO}:
            return Group(self._reader, address, path, msgs)
        if _LAYOUT in kinds:
            return Dataset(self._reader, address, path, msgs)
        raise NotImplementedError(f"{path!r} is neither a group nor a dataset")

    def __getitem__(self, path: str):
        node = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(f"no object {path!r} in {self.name!r}")
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self) -> List[str]:
        return sorted(self._links)

    def __len__(self) -> int:
        return len(self._links)

    def __repr__(self):
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


class File(Group):
    """An HDF5 file opened read-only from a path or from bytes held in
    memory (such as a member of a ``.keras`` zip)."""

    def __init__(self, source: Source):
        if isinstance(source, (str, os.PathLike)):
            with open(source, "rb") as fh:
                source = fh.read()
        reader = _Reader(memoryview(source).cast("B"))
        super().__init__(reader, reader.root, "/")


# ----------------------------------------------------------------------
# the writer
# ----------------------------------------------------------------------

# the largest attribute message of a version-1 object header (Keras splits
# longer lists into chunks at 64512 bytes)
_ATTRIBUTE_LIMIT = 64512
_LEAF_K = 4       # a symbol table node holds up to 2K entries (h5py's default)
_INTERNAL_K = 16  # a group B-tree node holds up to 2K children


def _datatype_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    order = 1 if dtype.byteorder == ">" else 0
    if dtype.kind in "iu":
        bits = order | (0x08 if dtype.kind == "i" else 0)
        return (struct.pack("<B3sI", 0x10, bits.to_bytes(3, "little"), dtype.itemsize)
                + struct.pack("<HH", 0, 8 * dtype.itemsize))
    if dtype.kind == "f":
        sign, exp_loc, exp_size, mant, bias = {
            2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023),
        }[dtype.itemsize]
        bits = order | 0x20 | (sign << 8)
        return (struct.pack("<B3sI", 0x11, bits.to_bytes(3, "little"), dtype.itemsize)
                + struct.pack("<HHBBBBI", 0, 8 * dtype.itemsize, exp_loc, exp_size,
                              0, mant, bias))
    raise NotImplementedError(f"the HDF5 writer takes numeric datasets, not {dtype}")


def _string_datatype(size: int) -> bytes:
    # class 3, null-padded, UTF-8
    return struct.pack("<B3sI", 0x13, (0x01 | 0x10).to_bytes(3, "little"), size)


def _dataspace_message(shape: Tuple[int, ...]) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", d) for d in shape)


def _message(mtype: int, data: bytes) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


def _attribute_message(name: str, value: Union[str, Sequence[str]]) -> bytes:
    """A string attribute: one string (a scalar), or a list of strings (a
    1-d array of fixed-length strings, null-padded to the longest, as
    ``h5py`` writes a numpy ``S`` array)."""
    raw_name = name.encode("utf-8") + b"\0"
    if isinstance(value, str):
        raw = value.encode("utf-8")
        dtype, space = _string_datatype(max(len(raw), 1)), _dataspace_message(())
        data = raw or b"\0"
    else:
        items = [v.encode("utf-8") for v in value]
        size = max([len(v) for v in items] + [1])
        dtype, space = _string_datatype(size), _dataspace_message((len(items),))
        data = b"".join(v + b"\0" * (size - len(v)) for v in items)
    body = struct.pack("<BBHHH", 1, 0, len(raw_name), len(dtype), len(space))
    for part in (raw_name, dtype, space):
        body += part + b"\0" * (_pad8(len(part)) - len(part))
    if len(body) + len(data) > _ATTRIBUTE_LIMIT:
        raise ValueError(f"attribute {name!r} takes {len(data)} bytes, more than an "
                         "HDF5 object header holds; split it into chunks")
    return _message(_ATTRIBUTE, body + data)


class _Writer:
    def __init__(self):
        self.out = bytearray(96)  # the superblock, written last

    def _alloc(self, data: bytes) -> int:
        address = len(self.out)
        self.out += data
        self.out += b"\0" * (_pad8(len(self.out)) - len(self.out))
        return address

    def _header(self, messages: List[bytes]) -> int:
        body = b"".join(messages)
        return self._alloc(struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)

    def dataset(self, value: np.ndarray, attrs: Mapping[str, Any]) -> int:
        value = np.asarray(value)
        if value.dtype.byteorder == ">":
            value = value.astype(value.dtype.newbyteorder("<"))
        raw = np.ascontiguousarray(value).tobytes()
        address = self._alloc(raw) if raw else _UNDEFINED
        layout = struct.pack("<BBQQ", 3, 1, address, len(raw))
        messages = [_message(_DATASPACE, _dataspace_message(value.shape)),
                    _message(_DATATYPE, _datatype_message(value.dtype)),
                    _message(_LAYOUT, layout)]
        messages += [_attribute_message(k, v) for k, v in attrs.items()]
        return self._header(messages)

    def group(self, children: Dict[str, int], attrs: Mapping[str, Any]) -> int:
        names = sorted(children)
        heap = bytearray(8)  # offset 0: the empty name
        offsets = {}
        for name in names:
            offsets[name] = len(heap)
            raw = name.encode("utf-8") + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        heap_data = self._alloc(bytes(heap))
        heap_address = self._alloc(b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), 1, heap_data))
        # symbol table nodes, 2K entries at most, each padded to full size
        nodes = []
        for i in range(0, len(names), 2 * _LEAF_K):
            chunk = names[i:i + 2 * _LEAF_K]
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk))
            for name in chunk:
                node += struct.pack("<QQII16x", offsets[name], children[name], 0, 0)
            node += b"\0" * (8 + 2 * _LEAF_K * 40 - len(node))
            nodes.append((self._alloc(node), offsets[chunk[-1]]))
        # B-tree levels from the leaves up, until one node holds the rest
        level = 0
        while True:
            fan = 2 * _INTERNAL_K
            nodes = self._btree_level(
                [nodes[i:i + fan] for i in range(0, max(len(nodes), 1), fan)], level)
            if len(nodes) == 1:
                btree = nodes[0][0]
                break
            level += 1
        stab = _message(_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_address))
        return self._header([stab] + [_attribute_message(k, v) for k, v in attrs.items()])

    def _btree_level(self, groups: List[List[Tuple[int, int]]], level: int):
        """One level of group B-tree nodes, each over one list of (child
        address, heap offset of its greatest name); siblings linked."""
        size = 8 + 16 + 2 * _INTERNAL_K * 8 + (2 * _INTERNAL_K + 1) * 8
        first = len(self.out)
        addresses = [first + i * size for i in range(len(groups))]
        for i, children in enumerate(groups):
            left = addresses[i - 1] if i else _UNDEFINED
            right = addresses[i + 1] if i + 1 < len(groups) else _UNDEFINED
            node = b"TREE" + struct.pack("<BBHQQ", 0, level, len(children), left, right)
            node += struct.pack("<Q", 0)
            for child, key in children:
                node += struct.pack("<QQ", child, key)
            node += b"\0" * (size - len(node))
            self._alloc(node)
        return [(a, children[-1][1] if children else 0)
                for a, children in zip(addresses, groups)]

    def finish(self, root: int) -> bytes:
        sb = _SIGNATURE + struct.pack("<BBBBBBBB", 0, 0, 0, 0, 0, 8, 8, 0)
        sb += struct.pack("<HHI", _LEAF_K, _INTERNAL_K, 0)
        sb += struct.pack("<QQQQ", 0, _UNDEFINED, len(self.out), _UNDEFINED)
        sb += struct.pack("<QQII16x", 0, root, 0, 0)
        self.out[:len(sb)] = sb
        return bytes(self.out)


def write(target: Optional[Union[str, os.PathLike]], tree: Mapping[str, Any],
          attrs: Optional[Mapping[str, Mapping[str, Any]]] = None) -> bytes:
    """Write an HDF5 file of ``tree``: a nested mapping in which a mapping
    is a group and an array a contiguous dataset (little-endian integers or
    floats). ``attrs`` maps an object's path (``""`` or ``"/"`` for the
    root, ``"a/b"``) to its attributes: each a string, or a list of strings
    (a 1-d array of fixed-length strings). Writes to ``target`` when
    given; returns the file's bytes."""
    attrs = {k.strip("/"): v for k, v in (attrs or {}).items()}
    writer = _Writer()

    def emit(node, path: str) -> int:
        if isinstance(node, Mapping):
            children = {}
            for key, child in node.items():
                if not key or "/" in key:
                    raise ValueError(f"bad HDF5 member name {key!r} under {path!r}")
                children[key] = emit(child, f"{path}/{key}".strip("/"))
            return writer.group(children, attrs.get(path, {}))
        return writer.dataset(np.asarray(node), attrs.get(path, {}))

    data = writer.finish(emit(tree, ""))
    if target is not None:
        with open(target, "wb") as fh:
            fh.write(data)
    return data
