"""The msgpack subset that flax.serialization writes, without msgpack or flax.

Counterpart of flax/serialization.py's msgpack_serialize / msgpack_restore,
which the JAX package's runtime/checkpointing.py (save_variables :23,
load_variables :30) uses for its variable files. The values are nil, bool,
int, float, str, bin, array and map, and two ext types of flax's
_MsgpackExtType:

  * 1, an ndarray: its payload is itself msgpack, the array
    (shape, dtype name, C-order bytes);
  * 3, a numpy scalar: the same payload for a 0-d array, read back as the
    scalar.

`serialize` writes the bytes flax writes for such a tree (msgpack's
smallest encodings, floats as float64, str and bin apart, each map's keys
sorted as flax's jax.tree_util.tree_map leaves them). `restore` reads
any encoding of these types; its arrays are read-only views into the
buffer, not copies. flax splits arrays over MAX_CHUNK_SIZE bytes into
chunks; no array of the models here is that large, and both directions
refuse one. bfloat16 leaves (flax reads them through jax) are refused too.
"""

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_CHUNK_SIZE = 2 ** 30
_CHUNKED = "__msgpack_chunked_array__"


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------

def _pack_int(out, x):
    if 0 <= x < 0x80:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif 0 <= x <= 0xFF:
        out += b"\xcc" + struct.pack(">B", x)
    elif 0 <= x <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", x)
    elif 0 <= x <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", x)
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", x)
    elif -0x80 <= x:
        out += b"\xd0" + struct.pack(">b", x)
    elif -0x8000 <= x:
        out += b"\xd1" + struct.pack(">h", x)
    elif -0x80000000 <= x:
        out += b"\xd2" + struct.pack(">i", x)
    elif -0x8000000000000000 <= x:
        out += b"\xd3" + struct.pack(">q", x)
    else:
        raise OverflowError(f"int {x} does not fit msgpack's 64 bits")


def _pack_len(out, n, small_tag, small_max, tags):
    """A length header: the fix form below small_max, else the 8/16/32-bit
    form of `tags` (None where the type has no 8-bit form)."""
    if small_tag is not None and n < small_max:
        out.append(small_tag | n)
    elif tags[0] is not None and n <= 0xFF:
        out += bytes([tags[0]]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += bytes([tags[1]]) + struct.pack(">H", n)
    elif n <= 0xFFFFFFFF:
        out += bytes([tags[2]]) + struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} entries or bytes")


def _pack_ext(out, code, data):
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _pack_len(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_payload(arr):
    if arr.dtype.hasobject or arr.dtype.fields is not None:
        raise ValueError("object and structured arrays are not serialised")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"array of {arr.nbytes} bytes: flax chunks arrays "
                         f"over {MAX_CHUNK_SIZE} bytes, which is not ported")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out, x):
    # Exact types, as flax's msgpack.packb(strict_types=True): np.float64
    # (a float subclass) is a numpy scalar, not a float.
    t = type(x)
    if x is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if x else 0xC2)
    elif t is int:
        _pack_int(out, x)
    elif t is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif t is str:
        data = x.encode("utf-8")
        _pack_len(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif t in (bytes, bytearray, memoryview):
        data = bytes(x)
        _pack_len(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif t is list:
        _pack_len(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif t is dict:
        _pack_len(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in sorted(x.items()):
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _array_payload(np.asarray(x)))
    else:
        raise TypeError(f"cannot serialise {t.__name__}")


def serialize(tree):
    """flax.serialization.msgpack_serialize for a tree of dicts and lists
    with the leaf types above (numpy arrays and scalars included)."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# --------------------------------------------------------------------------
# decoding
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack_from(self, fmt):
        (value,) = struct.unpack_from(fmt, self.take(struct.calcsize(fmt)))
        return value


_SIZED = {  # tag -> (kind, struct format of its length or value)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xCA: ("value", ">f"), 0xCB: ("value", ">d"),
    0xCC: ("value", ">B"), 0xCD: ("value", ">H"), 0xCE: ("value", ">I"),
    0xCF: ("value", ">Q"), 0xD0: ("value", ">b"), 0xD1: ("value", ">h"),
    0xD2: ("value", ">i"), 0xD3: ("value", ">q"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _unpack(r, raw=False):
    """One object. With `raw` (the ndarray payload, which flax reads so)
    str comes back as bytes and bin as a view into the buffer, else as str
    and bytes."""
    tag = r.take(1)[0]
    if tag <= 0x7F:
        return tag
    if tag >= 0xE0:
        return tag - 0x100
    if 0x80 <= tag <= 0x8F:
        return _unpack_map(r, tag & 0x0F, raw)
    if 0x90 <= tag <= 0x9F:
        return [_unpack(r, raw) for _ in range(tag & 0x0F)]
    if 0xA0 <= tag <= 0xBF:
        return _str(r.take(tag & 0x1F), raw)
    if tag == 0xC0:
        return None
    if tag in (0xC2, 0xC3):
        return tag == 0xC3
    if tag in _FIXEXT:
        return _ext(r.take(1)[0], r.take(_FIXEXT[tag]))
    if tag not in _SIZED:
        raise ValueError(f"msgpack type byte 0x{tag:02x} is not read")
    kind, fmt = _SIZED[tag]
    n = r.unpack_from(fmt)
    if kind == "value":
        return n
    if kind == "bin":
        return r.take(n) if raw else bytes(r.take(n))
    if kind == "str":
        return _str(r.take(n), raw)
    if kind == "array":
        return [_unpack(r, raw) for _ in range(n)]
    if kind == "map":
        return _unpack_map(r, n, raw)
    code = r.take(1)[0]
    return _ext(code, r.take(n))


def _str(view, raw):
    return bytes(view) if raw else str(view, "utf-8")


def _unpack_map(r, n, raw):
    out = {}
    for _ in range(n):
        k = _unpack(r, raw)
        out[k] = _unpack(r, raw)
    if _CHUNKED in out:
        raise ValueError("chunked array (over 2^30 bytes): not read")
    return out


def _ext(code, data):
    if code not in (EXT_NDARRAY, EXT_NPSCALAR):
        raise ValueError(f"msgpack ext type {code} is not read")
    r = _Reader(data)
    shape, name, buf = _unpack(r, raw=True)
    name = bytes(name).decode("ascii")
    if name == "bfloat16":
        raise ValueError("bfloat16 leaves are not read")
    arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)
    return arr[()] if code == EXT_NPSCALAR else arr


def restore(buf):
    """flax.serialization.msgpack_restore: the tree of `buf` (bytes, or any
    buffer, e.g. a memory map), its arrays read-only views into `buf`."""
    r = _Reader(buf)
    tree = _unpack(r)
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack object")
    return tree
