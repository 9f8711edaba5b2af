"""Flax's msgpack checkpoint format, read and written in pure Python.

The JAX package writes its ``.ckpt`` files with flax's ``serialization``
(``rel_pose_tpu/train/checkpoint.py:34-42``): a msgpack map of the train
state in which

  * every array is ext type 1, whose payload is itself msgpack: the tuple
    (shape, dtype name, C-order bytes); ``bfloat16`` data is read as
    ``uint16`` and viewed as ``torch.bfloat16`` (numpy has no bf16);
  * a numpy scalar is ext type 3, the same payload of a 0-d array;
  * a list or tuple is a map keyed ``"0"``, ``"1"``, ...: the JAX
    ``params["blocks"]`` is ``{"blocks": {"0": ..., "1": ...}}`` on disk;
  * a leaf over 2**30 bytes is split into a ``{"__msgpack_chunked_array__":
    True, "shape", "chunks"}`` map.

The host that runs the port has neither flax nor the ``msgpack`` package,
so :func:`unpackb` decodes every msgpack type flax emits (maps, arrays,
str and bin at all widths, fixext and ext, ints, floats, nil, bool) and
reassembles chunked arrays; :func:`packb` writes what flax's
``msgpack_restore`` reads back, byte for byte what its ``msgpack_serialize``
writes for the same tree (sorted str keys, arrays as ext 1, bin for bytes,
lists as digit-keyed maps); it splits no leaf into chunks, which leaves of
this model (at most a few MB) never need.  An ext code other than 1, 2 and 3 raises.
"""

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width tags: tag -> (struct format, byte count)
_SCALARS = {0xca: (">f", 4), 0xcb: (">d", 8),
            0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
            0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
# variable-length tags: tag -> (kind, width of the length field)
_SIZED = {0xc4: ("bin", 1), 0xc5: ("bin", 2), 0xc6: ("bin", 4),
          0xc7: ("ext", 1), 0xc8: ("ext", 2), 0xc9: ("ext", 4),
          0xd9: ("str", 1), 0xda: ("str", 2), 0xdb: ("str", 4),
          0xdc: ("array", 2), 0xdd: ("array", 4),
          0xde: ("map", 2), 0xdf: ("map", 4)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_UINT = {1: ">B", 2: ">H", 4: ">I"}


class _Decoder:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, width):
        return struct.unpack(_UINT[width], self.take(width))[0]

    def value(self):
        tag = self.take(1)[0]
        if tag <= 0x7f:
            return tag
        if tag >= 0xe0:
            return tag - 0x100
        if tag <= 0x8f:
            return self.map(tag & 0x0f)
        if tag <= 0x9f:
            return self.array(tag & 0x0f)
        if tag <= 0xbf:
            return str(self.take(tag & 0x1f), "utf-8")
        if tag == 0xc0:
            return None
        if tag in (0xc2, 0xc3):
            return tag == 0xc3
        if tag in _SCALARS:
            fmt, n = _SCALARS[tag]
            return struct.unpack(fmt, self.take(n))[0]
        if tag in _FIXEXT:
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, self.take(_FIXEXT[tag]))
        if tag not in _SIZED:
            raise ValueError(f"invalid msgpack tag 0x{tag:02x}")
        kind, width = _SIZED[tag]
        n = self.uint(width)
        if kind == "map":
            return self.map(n)
        if kind == "array":
            return self.array(n)
        if kind == "ext":
            code = struct.unpack(">b", self.take(1))[0]
            return _ext(code, self.take(n))
        raw = self.take(n)
        return str(raw, "utf-8") if kind == "str" else bytes(raw)

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n):
        return [self.value() for _ in range(n)]


def _ndarray(payload):
    """An ext 1 / 3 payload -> a writable numpy array, or a bfloat16
    tensor."""
    shape, name, data = _Decoder(payload).value()
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(data, np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits).view(torch.bfloat16)
    return np.frombuffer(data, np.dtype(name)).reshape(shape).copy()


def _ext(code, payload):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        arr = _ndarray(payload)
        return arr if torch.is_tensor(arr) else arr[()]
    if code == EXT_COMPLEX:
        real, imag = _Decoder(payload).value()
        return complex(real, imag)
    raise ValueError(f"unknown msgpack ext type {code}")


def _digit_list(d):
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree):
    """Reassemble flax's chunked arrays (``serialization.py:364-390``)."""
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = tuple(_digit_list(tree["shape"]))
        chunks = _digit_list(tree["chunks"])
        if chunks and torch.is_tensor(chunks[0]):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def unpackb(data):
    """msgpack bytes as flax writes them -> a tree of dicts (str keys),
    lists, Python scalars, numpy arrays and bfloat16 tensors."""
    dec = _Decoder(data)
    out = dec.value()
    if dec.pos != len(dec.buf):
        raise ValueError(f"{len(dec.buf) - dec.pos} bytes after the msgpack "
                         "object")
    return _unchunk(out)


# ----------------------------------------------------------------- write --

def _head(out, n, fix, fix_limit, tags):
    """A map / array / str / bin header: the fixed form below
    ``fix_limit``, else the narrowest of ``tags`` (8, 16, 32-bit length;
    None where msgpack has no such form)."""
    if fix is not None and n < fix_limit:
        out.append(struct.pack(">B", fix | n))
        return
    for tag, width in zip(tags, (1, 2, 4)):
        if tag is not None and n < 1 << (8 * width):
            out.append(struct.pack(">B", tag) + struct.pack(_UINT[width], n))
            return
    raise ValueError(f"msgpack object of {n} entries is too large")


def _int(out, v):
    if 0 <= v < 128:
        out.append(struct.pack(">B", v))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for tag, fmt, limit in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
            if v < limit:
                out.append(struct.pack(">B", tag) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")
    else:
        for tag, fmt, limit in ((0xd0, ">b", 1 << 7), (0xd1, ">h", 1 << 15),
                                (0xd2, ">i", 1 << 31), (0xd3, ">q", 1 << 63)):
            if v >= -limit:
                out.append(struct.pack(">B", tag) + struct.pack(fmt, v))
                return
        raise ValueError(f"integer {v} does not fit msgpack")


def _ext_out(out, code, payload):
    n = len(payload)
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        out.append(struct.pack(">B", fixed[n]))
    else:
        _head(out, n, None, 0, (0xc7, 0xc8, 0xc9))
    out.append(struct.pack(">b", code))
    out.append(payload)


def _array_payload(arr):
    """(shape, dtype name, C-order bytes) of a numpy array or tensor."""
    if torch.is_tensor(arr):
        arr = arr.detach().cpu().contiguous()
        if arr.dtype == torch.bfloat16:
            return (tuple(arr.shape), "bfloat16",
                    arr.view(torch.int16).numpy().tobytes())
        arr = arr.numpy()
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be written")
    return arr.shape, arr.dtype.name, arr.tobytes("C")


def _pack(out, v):
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _int(out, v)
    elif isinstance(v, float):
        out.append(b"\xcb" + struct.pack(">d", v))
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        _head(out, len(raw), 0xa0, 32, (0xd9, 0xda, 0xdb))
        out.append(raw)
    elif isinstance(v, (bytes, bytearray)):
        _head(out, len(v), None, 0, (0xc4, 0xc5, 0xc6))
        out.append(bytes(v))
    elif isinstance(v, dict):
        _head(out, len(v), 0x80, 16, (None, 0xde, 0xdf))
        bad = [k for k in v if not isinstance(k, str)]
        if bad:
            raise ValueError(f"msgpack checkpoint keys are str, got "
                             f"{bad[0]!r}")
        for key in sorted(v):   # flax's tree_map leaves the keys sorted
            _pack(out, key)
            _pack(out, v[key])
    elif isinstance(v, (list, tuple)):
        # flax's state-dict form of a sequence
        _pack(out, {str(i): item for i, item in enumerate(v)})
    elif isinstance(v, (np.ndarray, torch.Tensor)):
        _ext_out(out, EXT_NDARRAY, _payload(_array_payload(v)))
    elif isinstance(v, np.generic):
        _ext_out(out, EXT_NPSCALAR, _payload(_array_payload(np.asarray(v))))
    else:
        raise ValueError(f"cannot write {type(v).__name__} to msgpack")


def _payload(tpl):
    """msgpack of an array's (shape, dtype name, bytes): the shape is a
    msgpack array, as flax's ``msgpack.packb(tuple)`` writes it."""
    shape, name, data = tpl
    out = []
    out.append(b"\x93")
    _head(out, len(shape), 0x90, 16, (None, 0xdc, 0xdd))
    for d in shape:
        _int(out, int(d))
    _pack(out, name)
    _pack(out, data)
    return b"".join(out)


def packb(tree):
    """A tree of dicts (str keys), lists / tuples, Python scalars, str,
    bytes, numpy arrays or scalars and tensors -> msgpack bytes in flax's
    checkpoint format."""
    out = []
    _pack(out, tree)
    return b"".join(out)
