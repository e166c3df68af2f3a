"""Checkpointing: pytree <-> directory of .npz + msgpack metadata.

Counterpart of the JAX package's ``train/checkpoint.py``, with the same
layout, so a checkpoint either package writes loads into the other:

    <dir>/manifest.msgpack   {step, keys, metadata}
    <dir>/arrays.npz         flat arrays keyed by escaped path

Leaves: tensors go to host numpy; a Python int (the port's
``AdamWState.step``) is written as JAX writes its step, a 0-d int32
array, and read back as an int.  A bf16 tensor is written as its two
bytes a value (numpy has no bf16: ``np.savez`` stores JAX's ml_dtypes
bf16 as ``|V2`` too) and read back by viewing the bits wherever the
template leaf is bf16.

The manifest is msgpack, written and read by :func:`packb` and
:func:`unpackb` below (nil, bool, ints, float64, str, bytes, lists,
maps): the port imports nothing past torch, numpy and the standard
library, and those give ``msgpack.packb``'s bytes exactly.

``arrays.npz`` is what ``np.savez`` writes (stored members
``<key>.npy``), written from each array's own buffer, and read back one
member a thread straight into its array, each member's CRC-32 checked as
``np.load`` checks it: a checkpoint of a full-width model is gigabytes,
and ``np.savez``/``np.load`` move them at about 1 GB/s on one core.
"""
from __future__ import annotations

import os
import struct
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.utils.treeutil import tree_paths


# ---------------------------------------------------------------------------
# msgpack, the subset the manifest uses (the encodings msgpack.packb picks
# with its defaults: the smallest format for each value, str as UTF-8 str,
# bytes as bin, floats as float64)
# ---------------------------------------------------------------------------
def packb(obj: Any) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _pack_len(n: int, out: bytearray, fix: Optional[int], fix_max: int,
              codes: Tuple[int, ...]) -> None:
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n < 1 << 8:
        out += bytes((codes[0], n))
    elif n < 1 << 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 1 << 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack: length {n} past 2**32 - 1")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 15, (0, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: can not serialize {type(obj).__name__!r}")


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} too big to pack")
    else:
        for code, fmt, bot in ((0xD0, ">b", -(1 << 7)),
                               (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)),
                               (0xD3, ">q", -(1 << 63))):
            if n >= bot:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"msgpack: int {n} too big to pack")


# fixed-size formats: code -> (struct format, bytes)
_SCALARS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1),
            0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
            0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4),
            0xD3: (">q", 8)}
# length-prefixed formats: code -> (kind, bytes of the length)
_SIZED = {0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}


def unpackb(data: bytes) -> Any:
    """One msgpack object from ``data`` (which it must fill exactly), as
    ``msgpack.unpackb`` gives it by default: str decoded, arrays as
    lists, map keys str or bytes."""
    obj, end = _unpack(memoryview(bytes(data)), 0)
    if end != len(data):
        raise ValueError(f"msgpack: {len(data) - end} extra bytes")
    return obj


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    if i >= len(buf):
        raise ValueError("msgpack: data ends early")
    c = buf[i]
    i += 1
    if c <= 0x7F:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0x80 <= c <= 0x8F:
        return _unpack_map(buf, i, c & 0x0F)
    if 0x90 <= c <= 0x9F:
        return _unpack_array(buf, i, c & 0x0F)
    if 0xA0 <= c <= 0xBF:
        return _take(buf, i, c & 0x1F, "str")
    if c == 0xC0:
        return None, i
    if c in (0xC2, 0xC3):
        return c == 0xC3, i
    if c in _SCALARS:
        fmt, n = _SCALARS[c]
        if i + n > len(buf):
            raise ValueError("msgpack: data ends early")
        return struct.unpack(fmt, buf[i:i + n])[0], i + n
    if c in _SIZED:
        kind, n = _SIZED[c]
        if i + n > len(buf):
            raise ValueError("msgpack: data ends early")
        size = int.from_bytes(buf[i:i + n], "big")
        i += n
        if kind == "array":
            return _unpack_array(buf, i, size)
        if kind == "map":
            return _unpack_map(buf, i, size)
        return _take(buf, i, size, kind)
    raise ValueError(f"msgpack: format 0x{c:02x} is not supported")


def _take(buf: memoryview, i: int, n: int, kind: str) -> Tuple[Any, int]:
    if i + n > len(buf):
        raise ValueError("msgpack: data ends early")
    raw = bytes(buf[i:i + n])
    return (raw.decode("utf-8") if kind == "str" else raw), i + n


def _unpack_array(buf: memoryview, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, i = _unpack(buf, i)
        out.append(v)
    return out, i


def _unpack_map(buf: memoryview, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        if not isinstance(k, (str, bytes)):
            raise ValueError(f"msgpack: map key {type(k).__name__} is not "
                             "str or bytes")
        out[k], i = _unpack(buf, i)
    return out, i


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------
def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        if x.dtype == torch.bfloat16:  # its bits, as np.savez stores bf16
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    if isinstance(x, bool) or not isinstance(x, int):
        return np.asarray(x)
    return np.asarray(x, np.int32)  # an int step, as JAX's 0-d int32


def _from_numpy(arr: np.ndarray, like: Any) -> Any:
    if isinstance(like, torch.Tensor):
        if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
                and arr.dtype.kind in "Vf":  # V2 bits, or ml_dtypes' bf16
            t = torch.from_numpy(np.require(arr, requirements="C")
                                 .view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.require(arr, requirements="CW"))
        return t.to(like.device)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    return torch.from_numpy(np.array(arr))


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(v) for k, v in tree_paths(tree).items()}


def _unflatten_into(template, flat: Dict[str, np.ndarray]):
    def rec(prefix, node):
        if isinstance(node, dict):
            return {k: rec(f"{prefix}/{k}", v) for k, v in node.items()}
        if hasattr(node, "_fields"):
            return type(node)(**{
                f: rec(f"{prefix}/{f}", getattr(node, f)) for f in node._fields
            })
        if isinstance(node, (list, tuple)):
            t = type(node)
            return t(rec(f"{prefix}/{i}", v) for i, v in enumerate(node))
        return _from_numpy(flat[prefix], node)

    return rec("", template)


def _escape_key(k: str) -> str:
    """Invertible path-separator escaping (JSON-pointer style): ``~`` is
    the escape char, so a literal ``~`` becomes ``~0`` before ``/``
    becomes ``~1``."""
    return k.replace("~", "~0").replace("/", "~1")


def _unescape_key(k: str) -> str:
    # decode ~1 before ~0 (the JSON-pointer order): an original "~1"
    # escapes to "~01", which must NOT decode its tail as a separator
    return k.replace("~1", "/").replace("~0", "~")


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """``np.savez(path, **arrays)``'s file, each array written from its
    own buffer (``np.savez`` copies it out in 16 MB pieces first)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in arrays.items():
            arr = np.require(arr, requirements="C")  # keeps 0-d arrays 0-d
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                if arr.size:
                    f.write(memoryview(arr.reshape(-1).view(np.uint8)))


def _read_member(path: str, info: zipfile.ZipInfo) -> np.ndarray:
    """One stored ``.npy`` member read straight into its array, its CRC-32
    checked; anything else (compressed, Fortran order, objects) through
    numpy's own reader."""
    def numpys():
        with zipfile.ZipFile(path) as zf, zf.open(info) as m:
            return np.lib.format.read_array(m)

    if info.compress_type != zipfile.ZIP_STORED:
        return numpys()
    with open(path, "rb") as f:
        f.seek(info.header_offset)
        local = f.read(30)
        if local[:4] != b"PK\x03\x04":
            return numpys()
        start = info.header_offset + 30 + sum(struct.unpack("<HH",
                                                            local[26:30]))
        f.seek(start)
        version = np.lib.format.read_magic(f)
        read_header = (np.lib.format.read_array_header_1_0
                       if version == (1, 0)
                       else np.lib.format.read_array_header_2_0)
        shape, fortran, dtype = read_header(f)
        head = f.tell() - start
        if fortran or dtype.hasobject:
            return numpys()
        arr = np.empty(shape, dtype)
        f.seek(start)
        crc = zlib.crc32(f.read(head))
        data = memoryview(arr.reshape(-1).view(np.uint8))
        if f.readinto(data) != data.nbytes or info.file_size != \
                head + data.nbytes:
            raise zipfile.BadZipFile(f"{info.filename}: truncated")
        if zlib.crc32(data, crc) != info.CRC:
            raise zipfile.BadZipFile(f"Bad CRC-32 for file "
                                     f"{info.filename!r}")
        return arr


def _read_npz(path: str) -> Dict[str, np.ndarray]:
    """Every member of an ``.npz`` by key, the members read in parallel
    (file reads and CRC-32 release the GIL)."""
    with zipfile.ZipFile(path) as zf:
        infos = [i for i in zf.infolist() if i.filename.endswith(".npy")]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        arrays = list(ex.map(lambda i: _read_member(path, i), infos))
    return {i.filename[:-4]: a for i, a in zip(infos, arrays)}


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat = _flatten(tree)
    _write_npz(os.path.join(path, "arrays.npz"),
               {_escape_key(k): v for k, v in flat.items()})
    manifest = {"step": step, "keys": list(flat.keys()),
                "metadata": metadata or {}}
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(packb(manifest))


def checkpoint_exists(path: str) -> bool:
    return (os.path.exists(os.path.join(path, "manifest.msgpack"))
            and os.path.exists(os.path.join(path, "arrays.npz")))


def load_checkpoint(path: str, template: Any) -> Tuple[Any, int, Dict]:
    """(tree shaped like ``template``, step, metadata).  Each tensor lands
    on its template leaf's device."""
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    z = _read_npz(os.path.join(path, "arrays.npz"))
    flat: Dict[str, np.ndarray] = {}
    for k in manifest["keys"]:
        esc = _escape_key(k)
        if esc in z:
            flat[k] = z[esc]
        elif k.replace("/", "|") in z:  # legacy "|" checkpoints
            flat[k] = z[k.replace("/", "|")]
        else:
            raise KeyError(f"checkpoint {path} is missing array {k!r}")
    tree = _unflatten_into(template, flat)
    return tree, manifest["step"], manifest.get("metadata", {})
