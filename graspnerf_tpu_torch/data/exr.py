"""Minimal OpenEXR 2.0 scanline I/O in pure numpy.

A copy of graspnerf_tpu/data/exr.py: importing any module of the JAX
package imports jax, which the port never does.

The reference's vgn_syn contract stores depth and mask as `.exr`
(ref src/nr/dataset/database.py:129-198 reads them with cv2's EXR decoder).
This environment ships no EXR backend (cv2 built without OpenEXR, no OpenEXR
module, no imageio plugin), so the contract is implemented directly:

  write_exr(path, arr)   single-part scanline file, NO_COMPRESSION,
                         FLOAT or HALF channels — readable by any
                         standards-compliant reader (cv2, OpenEXR, Blender).
  read_exr(path)         reads NO_COMPRESSION, ZIP and ZIPS scanline files
                         (ZIP/ZIPS = what Blender/Cycles writes by default),
                         FLOAT/HALF/UINT channels.

Format reference: OpenEXR TechnicalIntroduction + openexr file layout docs.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_PT_UINT, _PT_HALF, _PT_FLOAT = 0, 1, 2
_NO_COMPRESSION, _RLE, _ZIPS, _ZIP = 0, 1, 2, 3
_PT_DTYPE = {_PT_UINT: np.uint32, _PT_HALF: np.float16, _PT_FLOAT: np.float32}


def _attr(name: bytes, typ: bytes, value: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(value)) + value


def write_exr(path: str, arr: np.ndarray, half: bool = False,
              channel_names: Tuple[str, ...] | None = None) -> None:
    """Write [H,W] or [H,W,C] float data as an uncompressed scanline EXR.

    Channel naming follows the common convention: 1 ch → "Y"; 3 ch → B,G,R
    (stored alphabetically, as EXR requires); otherwise c0..cN.
    """
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    H, W, C = arr.shape
    if channel_names is None:
        channel_names = (("Y",) if C == 1 else
                         ("R", "G", "B") if C == 3 else
                         tuple(f"c{i}" for i in range(C)))
    # EXR stores channels alphabetically; remember the data column per name
    order = sorted(range(C), key=lambda i: channel_names[i])
    ptype = _PT_HALF if half else _PT_FLOAT
    dt = _PT_DTYPE[ptype]
    data = arr.astype(dt)

    chlist = b""
    for i in order:
        chlist += (channel_names[i].encode() + b"\0"
                   + struct.pack("<i", ptype) + b"\0\0\0\0"
                   + struct.pack("<ii", 1, 1))
    chlist += b"\0"

    box = struct.pack("<iiii", 0, 0, W - 1, H - 1)
    header = b"".join([
        _attr(b"channels", b"chlist", chlist),
        _attr(b"compression", b"compression", bytes([_NO_COMPRESSION])),
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", b"\0"),
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
    ]) + b"\0"

    pre = len(_MAGIC) + 4 + len(header) + 8 * H
    bytes_per_line = 8 + W * C * dt().itemsize
    offsets = struct.pack("<%dQ" % H,
                          *[pre + y * bytes_per_line for y in range(H)])
    with open(path, "wb") as f:
        f.write(_MAGIC + struct.pack("<i", 2) + header + offsets)
        for y in range(H):
            line = b"".join(data[y, :, i].tobytes() for i in order)
            f.write(struct.pack("<ii", y, len(line)) + line)


def _read_header(f) -> Dict:
    if f.read(4) != _MAGIC:
        raise ValueError("not an EXR file")
    version = struct.unpack("<i", f.read(4))[0]
    if version & 0x200:
        raise ValueError("multi-part EXR not supported")
    attrs = {}
    while True:
        name = _read_cstr(f)
        if not name:
            break
        typ = _read_cstr(f)
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name] = (typ, f.read(size))
    return attrs


def _read_cstr(f) -> str:
    out = b""
    while True:
        c = f.read(1)
        if c in (b"\0", b""):
            return out.decode()
        out += c


def _parse_chlist(raw: bytes):
    chans = []
    i = 0
    while raw[i] != 0:
        j = raw.index(b"\0", i)
        name = raw[i:j].decode()
        ptype = struct.unpack_from("<i", raw, j + 1)[0]
        chans.append((name, ptype))
        i = j + 1 + 4 + 4 + 8
    return chans


def _zip_reconstruct(buf: bytes) -> bytes:
    """EXR zip predictor inverse (ImfZip.cpp): sequential delta-decode
    t[i] += t[i-1] - 128 (vectorized as a cumulative sum mod 256), then
    de-interleave the two halves into alternating bytes."""
    t = np.frombuffer(buf, np.uint8).astype(np.int64)
    # t[i] = t[i] + t[i-1] - 128 (sequential) == cumsum(t - 128) + 128... :
    # define u[0]=t[0]; u[i]=u[i-1]+t[i]-128  → u = cumsum(t') + t[0] where
    # t'[i] = t[i]-128 for i>=1
    tp = t.copy()
    tp[1:] -= 128
    u = np.cumsum(tp) % 256
    u = u.astype(np.uint8)
    # de-interleave: first half -> even positions, second half -> odd
    n = len(u)
    out = np.empty(n, np.uint8)
    half = (n + 1) // 2
    out[0::2] = u[:half]
    out[1::2] = u[half:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a single-part scanline EXR → [H,W] (one channel) or [H,W,C]
    float32 (channels re-ordered R,G,B when present)."""
    with open(path, "rb") as f:
        attrs = _read_header(f)
        chans = _parse_chlist(attrs["channels"][1])
        comp = attrs["compression"][1][0]
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"][1])
        W, H = x1 - x0 + 1, y1 - y0 + 1
        if comp == _NO_COMPRESSION or comp == _ZIPS:
            lines_per_chunk = 1
        elif comp == _ZIP:
            lines_per_chunk = 16
        else:
            raise ValueError(f"unsupported EXR compression {comp}")
        n_chunks = (H + lines_per_chunk - 1) // lines_per_chunk
        struct.unpack("<%dQ" % n_chunks, f.read(8 * n_chunks))  # offsets

        dts = [_PT_DTYPE[pt] for _, pt in chans]
        out = {name: np.empty((H, W), np.float32) for name, _ in chans}
        for _ in range(n_chunks):
            y, size = struct.unpack("<ii", f.read(8))
            raw = f.read(size)
            ny = min(lines_per_chunk, H - (y - y0))
            expect = sum(W * dt().itemsize for dt in dts) * ny
            if comp in (_ZIP, _ZIPS) and size != expect:
                raw = _zip_reconstruct(zlib.decompress(raw))
            pos = 0
            for line in range(ny):
                for (name, _), dt in zip(chans, dts):
                    nb = W * dt().itemsize
                    row = np.frombuffer(raw, dt, W, pos)
                    out[name][y - y0 + line] = row.astype(np.float32)
                    pos += nb
    names = [n for n, _ in chans]
    if len(names) == 1:
        return out[names[0]]
    if set("RGB") <= set(names):
        order = ["R", "G", "B"] + sorted(set(names) - set("RGB"))
    else:
        order = names
    return np.stack([out[n] for n in order], -1)
