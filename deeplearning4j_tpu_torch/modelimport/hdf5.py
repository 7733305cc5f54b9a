"""HDF5 reader and writer for the subset that Keras model files use, in plain
Python and numpy (no libhdf5), with the same behaviour on every machine.

The subset is the file format that libhdf5 writes by default (its "earliest"
format, which h5py and Keras use):

  - superblock version 0 or 1, version 1 object headers (continuation
    blocks followed);
  - groups kept as symbol tables: a version 1 B-tree of SNOD nodes, names
    in a local heap;
  - datasets with contiguous or compact storage of integer or
    floating-point elements (chunked and filtered storage raise
    NotImplementedError);
  - attributes (version 1-3 messages) of numbers, fixed-length strings
    and variable-length strings, whose bytes live in global heap
    collections.

Reading mirrors h5py: `File(path)` gives a group; `attrs` is a dict;
`group[path]` resolves '/'-separated paths to a `Group` or a `Dataset`;
`np.asarray(dataset)` reads it; `visititems(fn)` walks depth-first in name
order. Numbers read in native byte order; a variable-length string reads
as `str` (arrays of them as object arrays of `str`), a fixed-length one as
`bytes`, as h5py 3 does.

Writing: `File(path, "w")` gives a group to fill with `require_group`,
`create_dataset(name, data=array)` and `attrs[name] = value`; the file is
laid out when it is closed. A `str` attribute is written as a
variable-length UTF-8 string, a list of `bytes` as an array of
variable-length ASCII strings, as h5py writes them, so that an attribute
larger than an object-header message (64 KiB; a Keras `model_config` can
be) is held in a global heap collection.

Format reference: the HDF5 File Format Specification, version 2.0,
sections II (superblock), III.A-C (B-trees, symbol table nodes, local and
global heaps) and IV.A (object headers and their messages).
"""
from __future__ import annotations

import mmap
import struct
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object-header message types
_NIL, _DATASPACE, _DATATYPE, _FILL, _LAYOUT = 0x0, 0x1, 0x3, 0x5, 0x8
_LINK, _ATTRIBUTE, _CONTINUATION, _SYMBOL_TABLE = 0x6, 0xC, 0x10, 0x11

# datatype classes
_FIXED, _FLOAT, _STRING, _VLEN = 0, 1, 3, 9


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def File(path, mode: str = "r"):
    """Open `path` for reading ("r") or create it for writing ("w"). Both
    work as context managers; a written file is laid out on `close()`."""
    if mode == "r":
        return _ReadFile(path)
    if mode == "w":
        return _WriteFile(path)
    raise ValueError(f"mode {mode!r}: this HDF5 module reads ('r') or "
                     f"writes a new file ('w')")


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Type:
    """A decoded datatype: kind "num" (a numpy dtype), "str" (fixed-length,
    `size` bytes) or "vstr" (variable-length string)."""

    def __init__(self, kind: str, size: int, dtype=None):
        self.kind, self.size, self.dtype = kind, size, dtype


class _Reader:
    """The file's bytes (memory-mapped) and the decoders of its
    structures."""

    def __init__(self, path):
        self._file = open(path, "rb")
        size = self._file.seek(0, 2)
        if size == 0:
            raise ValueError(f"{path}: empty file, not HDF5")
        self.buf = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        base = 0
        while base + 8 <= size and self.buf[base:base + 8] != SIGNATURE:
            base = 512 if base == 0 else base * 2
        if base + 8 > size:
            raise ValueError(f"{path}: no HDF5 signature")
        version = self.buf[base + 8]
        if version not in (0, 1):
            raise NotImplementedError(
                f"{path}: superblock version {version} (libhdf5's 'latest' "
                f"format); this reader takes versions 0 and 1")
        self.so, self.sl = self.buf[base + 13], self.buf[base + 14]
        p = base + 24 + (4 if version == 1 else 0)
        self.base = self.uint(p, self.so)
        p += 4 * self.so  # base, free-space, end-of-file, driver addresses
        self.root = self.addr(p + self.sl)  # root symbol table entry
        self._gheaps: Dict[int, Dict[int, bytes]] = {}

    def close(self):
        self.buf.close()
        self._file.close()

    def uint(self, p: int, n: int) -> int:
        return int.from_bytes(self.buf[p:p + n], "little")

    def addr(self, p: int) -> int:
        """A file address at p, made absolute (UNDEF stays UNDEF)."""
        a = self.uint(p, self.so)
        return UNDEF if a == (1 << (8 * self.so)) - 1 else self.base + a

    # ---- object headers ----
    def messages(self, at: int) -> List[Tuple[int, int, int]]:
        """(type, flags, offset of the data) of each message of the version
        1 object header at `at`, continuation blocks followed."""
        if self.buf[at] != 1:
            raise NotImplementedError(
                f"object header version {self.buf[at]} at {at} (libhdf5's "
                f"'latest' format); this reader takes version 1")
        blocks = [(at + 16, self.uint(at + 8, 4))]
        out = []
        while blocks:
            p, size = blocks.pop(0)
            end = p + size
            while p + 8 <= end:
                mtype, msize = self.uint(p, 2), self.uint(p + 2, 2)
                flags = self.buf[p + 4]
                if mtype == _CONTINUATION:
                    blocks.append((self.addr(p + 8),
                                   self.uint(p + 8 + self.so, self.sl)))
                elif mtype != _NIL:
                    if flags & 0x2:
                        raise NotImplementedError(
                            f"shared object-header message (type {mtype}) "
                            f"at {p}")
                    out.append((mtype, flags, p + 8))
                p += 8 + msize
        return out

    # ---- groups ----
    def links(self, msgs) -> Dict[str, int]:
        """name -> object header address of a symbol-table group."""
        for mtype, _, p in msgs:
            if mtype == _SYMBOL_TABLE:
                heap = self.addr(p + self.so)
                out: Dict[str, int] = {}
                self._walk_btree(self.addr(p), self._heap_data(heap), out)
                return out
            if mtype == _LINK:
                raise NotImplementedError(
                    "group with link messages (libhdf5's 'latest' format); "
                    "this reader takes symbol-table groups")
        raise ValueError("object is not a group")

    def _heap_data(self, at: int) -> int:
        if self.buf[at:at + 4] != b"HEAP":
            raise ValueError(f"no local heap at {at}")
        return self.addr(at + 8 + 2 * self.sl)

    def _walk_btree(self, at: int, heap: int, out: Dict[str, int]):
        if at == UNDEF:
            return
        if self.buf[at:at + 4] != b"TREE" or self.buf[at + 4] != 0:
            raise ValueError(f"no group B-tree node at {at}")
        level, used = self.buf[at + 5], self.uint(at + 6, 2)
        p = at + 8 + 2 * self.so + self.sl  # past the siblings and key 0
        for _ in range(used):
            child = self.addr(p)
            if level > 0:
                self._walk_btree(child, heap, out)
            else:
                self._read_snod(child, heap, out)
            p += self.so + self.sl

    def _read_snod(self, at: int, heap: int, out: Dict[str, int]):
        if self.buf[at:at + 4] != b"SNOD":
            raise ValueError(f"no symbol table node at {at}")
        n = self.uint(at + 6, 2)
        size = self.sl + self.so + 24
        for i in range(n):
            p = at + 8 + i * size
            name_at = heap + self.uint(p, self.sl)
            end = self.buf.find(b"\0", name_at)
            out[self.buf[name_at:end].decode("utf-8")] = self.addr(
                p + self.sl)

    # ---- datatypes, dataspaces, data ----
    def datatype(self, p: int) -> _Type:
        cls, version = self.buf[p] & 0x0F, self.buf[p] >> 4
        bits = self.uint(p + 1, 3)
        size = self.uint(p + 4, 4)
        if cls in (_FIXED, _FLOAT):
            order = ">" if bits & 1 else "<"
            if cls == _FLOAT:
                kind = "f"
            else:
                kind = "i" if bits & 0x8 else "u"
            return _Type("num", size, np.dtype(f"{order}{kind}{size}"))
        if cls == _STRING:
            return _Type("str", size)
        if cls == _VLEN and bits & 0xF == 1:
            return _Type("vstr", size)
        raise NotImplementedError(
            f"datatype class {cls} (version {version}); this reader takes "
            f"integers, floats and strings")

    def dataspace(self, p: int) -> Optional[Tuple[int, ...]]:
        """The shape (() for a scalar, None for a null dataspace)."""
        version, rank = self.buf[p], self.buf[p + 1]
        if version == 1:
            q = p + 8
        elif version == 2:
            if self.buf[p + 3] == 2:
                return None
            q = p + 4
        else:
            raise NotImplementedError(f"dataspace version {version}")
        return tuple(self.uint(q + i * self.sl, self.sl)
                     for i in range(rank))

    def decode(self, t: _Type, shape, raw: Optional[int]):
        """The value of `shape` elements of type `t` stored from `raw` (None:
        never written, read as zeros)."""
        if shape is None:
            return None
        count = int(np.prod(shape, dtype=np.int64))
        if t.kind == "num":
            if raw is None:
                arr = np.zeros(shape, t.dtype.newbyteorder("="))
            else:  # astype copies out of the mapped file
                arr = np.frombuffer(self.buf, t.dtype, count, raw).reshape(
                    shape).astype(t.dtype.newbyteorder("="))
            return arr[()] if shape == () else arr
        if t.kind == "str":
            arr = (np.zeros(shape, f"S{t.size}") if raw is None else
                   np.frombuffer(self.buf, f"S{t.size}", count,
                                 raw).reshape(shape).copy())
            return arr[()] if shape == () else arr
        vals = ([self._vlen_string(raw + (8 + self.so) * i)
                 for i in range(count)] if raw is not None else [""] * count)
        if shape == ():
            return vals[0]
        arr = np.empty(count, object)
        arr[:] = vals
        return arr.reshape(shape)

    def _vlen_string(self, p: int) -> str:
        n = self.uint(p, 4)
        coll, idx = self.addr(p + 4), self.uint(p + 4 + self.so, 4)
        if n == 0 or coll == UNDEF:
            return ""
        return self._global(coll)[idx][:n].decode("utf-8")

    def _global(self, at: int) -> Dict[int, bytes]:
        """The objects of the global heap collection at `at`, by index."""
        if at in self._gheaps:
            return self._gheaps[at]
        if self.buf[at:at + 4] != b"GCOL":
            raise ValueError(f"no global heap collection at {at}")
        end = at + self.uint(at + 8, self.sl)
        p = at + 8 + self.sl
        objs: Dict[int, bytes] = {}
        while p + 8 + self.sl <= end:
            idx = self.uint(p, 2)
            size = self.uint(p + 8, self.sl)
            if idx == 0:  # free space: the rest of the collection
                break
            start = p + 8 + self.sl
            objs[idx] = bytes(self.buf[start:start + size])
            p = start + _pad8(size)
        self._gheaps[at] = objs
        return objs

    def attributes(self, msgs) -> Dict[str, object]:
        out = {}
        for mtype, _, p in msgs:
            if mtype != _ATTRIBUTE:
                continue
            version = self.buf[p]
            name_n, dt_n, ds_n = (self.uint(p + 2, 2), self.uint(p + 4, 2),
                                  self.uint(p + 6, 2))
            if version == 1:
                q = p + 8
                pad = _pad8
            elif version in (2, 3):
                q = p + 8 + (1 if version == 3 else 0)
                pad = int
            else:
                raise NotImplementedError(f"attribute message version "
                                          f"{version}")
            name = bytes(self.buf[q:q + name_n]).rstrip(b"\0").decode("utf-8")
            q += pad(name_n)
            t = self.datatype(q)
            q += pad(dt_n)
            shape = self.dataspace(q)
            q += pad(ds_n)
            out[name] = self.decode(t, shape, q)
        return out


class Dataset:
    """A dataset of a file open for reading; `np.asarray(ds)` or `ds[()]`
    reads it."""

    def __init__(self, reader: _Reader, msgs, name: str):
        self.name = name
        self._r = reader
        self.attrs = reader.attributes(msgs)
        found = {m: p for m, _, p in msgs}
        self._type = reader.datatype(found[_DATATYPE])
        self.shape = reader.dataspace(found[_DATASPACE])
        self._raw = self._layout(found[_LAYOUT])
        self.dtype = (self._type.dtype.newbyteorder("=")
                      if self._type.kind == "num" else None)

    def _layout(self, p: int) -> Optional[int]:
        r = self._r
        version = r.buf[p]
        if version == 3:
            cls, q = r.buf[p + 1], p + 2
            if cls == 0:
                return q + 2
            if cls == 1:
                a = r.addr(q)
                return None if a == UNDEF else a
        elif version in (1, 2):
            rank, cls = r.buf[p + 1], r.buf[p + 2]
            if cls == 0:
                return p + 8 + 4 * rank + 4
            if cls == 1:
                a = r.addr(p + 8)
                return None if a == UNDEF else a
        else:
            raise NotImplementedError(f"data layout version {version}")
        raise NotImplementedError(
            f"dataset {self.name!r}: chunked storage; this reader takes "
            f"contiguous and compact datasets")

    def __getitem__(self, key):
        if key != () and key is not Ellipsis:
            raise TypeError("read the whole dataset: ds[()]")
        return self._r.decode(self._type, self.shape, self._raw)

    def __array__(self, dtype=None, copy=None):
        arr = self[()]
        return arr if dtype is None else arr.astype(dtype)


class Group:
    """A group of a file open for reading."""

    def __init__(self, reader: _Reader, msgs, name: str = "/"):
        self.name = name
        self._r = reader
        self.attrs = reader.attributes(msgs)
        self._links = reader.links(msgs)

    def keys(self) -> List[str]:
        return sorted(self._links, key=lambda s: s.encode("utf-8"))

    def _child(self, name: str):
        at = self._links[name]
        msgs = self._r.messages(at)
        path = f"{self.name.rstrip('/')}/{name}"
        if any(m == _SYMBOL_TABLE for m, _, _ in msgs):
            return Group(self._r, msgs, path)
        return Dataset(self._r, msgs, path)

    def __getitem__(self, path: str):
        obj = self
        for part in (p for p in str(path).split("/") if p):
            if not isinstance(obj, Group) or part not in obj._links:
                raise KeyError(f"{path!r} not in {self.name!r}")
            obj = obj._child(part)
        return obj

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def visititems(self, fn: Callable[[str, object], object], _prefix=""):
        """fn(relative path, object) for every object below this group,
        depth-first in name order (h5py's order); stops at the first call
        that returns something other than None."""
        for key in self.keys():
            obj = self._child(key)
            path = _prefix + key
            ret = fn(path, obj)
            if ret is not None:
                return ret
            if isinstance(obj, Group):
                ret = obj.visititems(fn, path + "/")
                if ret is not None:
                    return ret
        return None


class _ReadFile(Group):
    def __init__(self, path):
        reader = _Reader(path)
        try:
            super().__init__(reader, reader.messages(reader.root), "/")
        except Exception:
            reader.close()
            raise

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


class _NewDataset:
    def __init__(self, data: np.ndarray):
        self.data = data
        self.attrs: Dict[str, object] = {}


class _NewGroup:
    """A group of a file being written."""

    def __init__(self):
        self.children: Dict[str, Union["_NewGroup", _NewDataset]] = {}
        self.attrs: Dict[str, object] = {}

    def _parent_of(self, path: str) -> Tuple["_NewGroup", str]:
        parts = [p for p in str(path).split("/") if p]
        if not parts:
            raise ValueError(f"empty path {path!r}")
        g = self
        for part in parts[:-1]:
            g = g.require_group(part)
        return g, parts[-1]

    def require_group(self, path: str) -> "_NewGroup":
        g, name = self._parent_of(path)
        child = g.children.setdefault(name, _NewGroup())
        if not isinstance(child, _NewGroup):
            raise TypeError(f"{path!r} is a dataset")
        return child

    def create_dataset(self, path: str, data) -> _NewDataset:
        g, name = self._parent_of(path)
        if name in g.children:
            raise ValueError(f"{path!r} exists")
        arr = np.ascontiguousarray(np.asarray(data))
        if arr.dtype.kind not in "iuf":
            raise TypeError(f"dataset {path!r}: dtype {arr.dtype}; this "
                            f"writer stores integers and floats")
        ds = _NewDataset(arr.astype(arr.dtype.newbyteorder("<")))
        g.children[name] = ds
        return ds


def _enc_datatype_num(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind == "f":
        exp, mant, bias = {2: (5, 10, 15), 4: (8, 23, 127),
                           8: (11, 52, 1023)}[size]
        bits = 0x20 | ((8 * size - 1) << 8)  # implied msb; sign position
        return (struct.pack("<B3sI", 0x10 | _FLOAT, bits.to_bytes(3, "little"),
                            size)
                + struct.pack("<HHBBBBI", 0, 8 * size, mant, exp, 0, mant,
                              bias))
    bits = 0x8 if dtype.kind == "i" else 0
    return (struct.pack("<B3sI", 0x10 | _FIXED, bits.to_bytes(3, "little"),
                        size) + struct.pack("<HH", 0, 8 * size))


def _enc_datatype_vstr(utf8: bool) -> bytes:
    # variable-length string over unsigned bytes, null-terminated padding
    base = struct.pack("<B3sIHH", 0x10 | _FIXED, b"\0\0\0", 1, 0, 8)
    bits = 1 | ((1 if utf8 else 0) << 8)
    return struct.pack("<B3sI", 0x10 | _VLEN, bits.to_bytes(3, "little"),
                       16) + base


def _enc_datatype_str(size: int) -> bytes:
    # fixed-length, null-padded, ASCII
    return struct.pack("<B3sI", 0x10 | _STRING, b"\x01\0\0", size)


def _enc_dataspace(shape: Tuple[int, ...]) -> bytes:
    """Version 1 (rank 0: a scalar), maximum dimensions = dimensions."""
    flags = 1 if shape else 0
    out = struct.pack("<BBBB4x", 1, len(shape), flags, 0)
    dims = b"".join(struct.pack("<Q", d) for d in shape)
    return out + dims + (dims if shape else b"")


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    if len(data) > 0xFFFF:
        raise ValueError(f"object-header message of {len(data)} bytes "
                         f"(type {mtype}) exceeds 64 KiB")
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


class _Out:
    """The file being written: space is handed out at its end, 8-byte
    aligned; each structure is written once its bytes are known."""

    def __init__(self, f):
        self.f = f
        self.eof = 0

    def alloc(self, n: int) -> int:
        at = self.eof
        self.eof += _pad8(n)
        return at

    def put(self, at: int, data: bytes):
        self.f.seek(at)
        self.f.write(data)

    def place(self, data: bytes) -> int:
        at = self.alloc(len(data))
        self.put(at, data)
        return at


class _Writer:
    INTERNAL_K = 16  # libhdf5's default group B-tree rank

    def __init__(self, out: _Out, leaf_k: int):
        self.out = out
        self.leaf_k = leaf_k

    def attribute(self, name: str, value) -> bytes:
        if isinstance(value, str):
            dt, shape, data = self._vstrings([value], (), True)
        elif isinstance(value, (bytes, np.bytes_)):
            dt, shape, data = self._vstrings([bytes(value)], (), False)
        else:
            arr = np.asarray(value)
            if arr.dtype.kind in "SO" or (arr.dtype.kind == "U"):
                items = [v if isinstance(v, (bytes, str)) else str(v)
                         for v in arr.ravel().tolist()]
                utf8 = any(isinstance(v, str) for v in items)
                dt, shape, data = self._vstrings(items, arr.shape, utf8)
            elif arr.dtype.kind in "iuf":
                arr = np.ascontiguousarray(
                    arr.astype(arr.dtype.newbyteorder("<")))
                dt, shape, data = (_enc_datatype_num(arr.dtype), arr.shape,
                                   arr.tobytes())
            else:
                raise TypeError(f"attribute {name!r}: cannot store "
                                f"{type(value).__name__}")
        nm = name.encode("utf-8") + b"\0"
        ds = _enc_dataspace(tuple(shape))

        def padded(b):
            return b + b"\0" * (_pad8(len(b)) - len(b))

        body = (struct.pack("<BBHHH", 1, 0, len(nm), len(dt), len(ds))
                + padded(nm) + padded(dt) + padded(ds) + data)
        return _message(_ATTRIBUTE, body)

    def _vstrings(self, items, shape, utf8: bool):
        """Variable-length strings: their bytes in one global heap
        collection, each element (length, collection, index)."""
        raw = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
               for v in items]
        objs = b"".join(struct.pack("<HH4xQ", i + 1, 0, len(b)) + b
                        + b"\0" * (_pad8(len(b)) - len(b))
                        for i, b in enumerate(raw))
        size = max(4096, 16 + len(objs) + 16)
        free = size - 16 - len(objs)
        coll = (b"GCOL" + struct.pack("<B3xQ", 1, size) + objs
                + struct.pack("<HH4xQ", 0, 0, free))
        at = self.out.alloc(size)
        self.out.put(at, coll + b"\0" * (size - len(coll)))
        data = b"".join(struct.pack("<IQI", len(b), at, i + 1)
                        for i, b in enumerate(raw))
        return _enc_datatype_vstr(utf8), shape, data

    def header(self, msgs: List[bytes]) -> int:
        body = b"".join(msgs)
        pre = struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body))
        return self.out.place(pre + body)

    def dataset(self, ds: _NewDataset) -> int:
        arr = ds.data
        raw = arr.tobytes()
        at = self.out.place(raw) if raw else UNDEF
        layout = struct.pack("<BBQQ", 3, 1, at, len(raw))
        fill = struct.pack("<BBBB", 2, 2, 2, 0)  # late, if set, undefined
        msgs = [_message(_DATASPACE, _enc_dataspace(arr.shape)),
                _message(_DATATYPE, _enc_datatype_num(arr.dtype), 1),
                _message(_FILL, fill, 1),
                _message(_LAYOUT, layout)]
        msgs += [self.attribute(k, v) for k, v in ds.attrs.items()]
        return self.header(msgs)

    def group(self, g: _NewGroup) -> Tuple[int, int, int]:
        """Writes `g` and everything below it; returns the addresses of its
        object header, B-tree and local heap."""
        names = sorted(g.children, key=lambda s: s.encode("utf-8"))
        entries = []
        for name in names:
            child = g.children[name]
            if isinstance(child, _NewGroup):
                entries.append((name, *self.group(child)))
            else:
                entries.append((name, self.dataset(child), None, None))
        # local heap: "" at offset 0, then each name, null-terminated
        heap, offsets = bytearray(8), []
        for name, *_ in entries:
            offsets.append(len(heap))
            b = name.encode("utf-8") + b"\0"
            heap += b + b"\0" * (_pad8(len(b)) - len(b))
        heap_at = self.out.alloc(32 + len(heap))
        self.out.put(heap_at, b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap), 1, heap_at + 32) + bytes(heap))
        # one symbol table node holding every entry, in name order
        snod = bytearray(b"SNOD" + struct.pack("<BxH", 1, len(entries)))
        for off, (name, hdr, btree, lheap) in zip(offsets, entries):
            if btree is None:
                snod += struct.pack("<QQII16x", off, hdr, 0, 0)
            else:
                snod += struct.pack("<QQIIQQ", off, hdr, 1, 0, btree, lheap)
        snod_size = 8 + 2 * self.leaf_k * 40
        # a group B-tree node sized for 2K children (libhdf5 reads it whole)
        k2 = 2 * self.INTERNAL_K
        node = bytearray(b"TREE" + struct.pack(
            "<BBHQQ", 0, 0, 1 if entries else 0, UNDEF, UNDEF))
        node += struct.pack("<Q", 0)
        if entries:
            snod_at = self.out.alloc(snod_size)
            self.out.put(snod_at, bytes(snod) + b"\0" * (snod_size
                                                        - len(snod)))
            node += struct.pack("<QQ", snod_at, offsets[-1])
        node_size = 24 + k2 * 8 + (k2 + 1) * 8
        btree_at = self.out.alloc(node_size)
        self.out.put(btree_at, bytes(node) + b"\0" * (node_size - len(node)))
        msgs = [_message(_SYMBOL_TABLE, struct.pack("<QQ", btree_at,
                                                    heap_at))]
        msgs += [self.attribute(k, v) for k, v in g.attrs.items()]
        return self.header(msgs), btree_at, heap_at


def _most_children(g: _NewGroup) -> int:
    sub = [_most_children(c) for c in g.children.values()
           if isinstance(c, _NewGroup)]
    return max([len(g.children)] + sub)


class _WriteFile(_NewGroup):
    SUPERBLOCK = 96  # version 0, 8-byte addresses and lengths

    def __init__(self, path):
        super().__init__()
        self.path = path
        self._closed = False

    def close(self):
        """Lays the file out: superblock, then each group's objects, names,
        symbol table node and B-tree node, depth first."""
        if self._closed:
            return
        self._closed = True
        leaf_k = max(4, (_most_children(self) + 1) // 2)
        with open(self.path, "wb") as f:
            out = _Out(f)
            out.alloc(self.SUPERBLOCK)
            root, btree, heap = _Writer(out, leaf_k).group(self)
            f.truncate(out.eof)
            sb = (SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
                  + struct.pack("<HHI", leaf_k, _Writer.INTERNAL_K, 0)
                  + struct.pack("<QQQQ", 0, UNDEF, out.eof, UNDEF)
                  + struct.pack("<QQIIQQ", 0, root, 1, 0, btree, heap))
            out.put(0, sb)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.close()
