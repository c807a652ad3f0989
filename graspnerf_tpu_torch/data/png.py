"""8-bit PNG I/O in numpy and zlib, so that the dataset writer and reader
need no image library (the card's machine has none).

  write_png(path, img)  the bytes PIL's `Image.fromarray(img).save(path)`
                        writes: IHDR, the image data filtered row by row
                        with PIL's choice of filter (None, Up, Sub, Paeth:
                        the least sum of |byte| as a signed value, in that
                        order of trial, a later one only if strictly less),
                        deflated at level 6, window 15, memory level 9 with
                        the Z_FILTERED strategy and cut into IDAT chunks of
                        max(65536, 4 * width) bytes, then IEND. Equal bytes
                        need the same zlib as PIL's.
  read_pngs(paths)      8-bit grey, grey + alpha, RGB and RGBA images, not
                        interlaced; ValueError for any other. Images of one
                        size are unfiltered together (see `_unfilter`).
  png_header(path)      (width, height, bit depth, colour type, interlace)
                        from the IHDR, without decoding.
  read_rgb(paths, wh)   PNGs as float32 RGB in [0, 1] at `wh`, as PIL's
                        convert("RGB") and bilinear resize give them: PIL
                        where it imports, else `read_pngs` for 8-bit PNGs
                        already at `wh` (ImportError for any other image).
  save_png(path, img)   PIL's `Image.fromarray(img).save(path)` where PIL
                        imports, else `write_png`.

Format reference: the PNG specification (ISO/IEC 15948), sections 5-9.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}      # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPES.items()}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


# each byte's distance from 0 as a signed value: PIL's filter heuristic
_COST = np.minimum(np.arange(256), 256 - np.arange(256))


def _filter_rows(raw: np.ndarray, bpp: int) -> bytes:
    """raw [h, stride] uint8 -> the filtered scanlines, each led by its
    filter type byte, as PIL's encoder chooses them: each row's candidates
    depend on the raw rows only, so all rows are filtered at once."""
    h, stride = raw.shape
    prev = np.concatenate([np.zeros((1, stride), np.uint8), raw[:-1]])
    left = np.pad(raw, ((0, 0), (bpp, 0)))[:, :stride]
    upleft = np.pad(prev, ((0, 0), (bpp, 0)))[:, :stride]
    a, b, c = (t.astype(np.int16) for t in (left, prev, upleft))
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    # None, Up, Sub, Paeth: tried in this order, a later one taken only
    # while the best sum is above 0 and if its sum is strictly less
    cands = np.stack([raw, raw - prev, raw - left,
                      (raw - pred).astype(np.uint8)])
    costs = _COST[cands].sum(-1)
    pick = np.zeros(h, np.int64)
    best = costs[0]
    for i in (1, 2, 3):
        take = (best > 0) & (costs[i] < best)
        pick = np.where(take, i, pick)
        best = np.where(take, costs[i], best)
    kinds = np.array([0, 2, 1, 4], np.uint8)[pick]
    rows = cands[pick, np.arange(h)]
    return np.concatenate([kinds[:, None], rows], 1).tobytes()


def encode_png(img: np.ndarray) -> bytes:
    """[h, w] or [h, w, c] uint8 (c in 1..4) -> the bytes of a PNG file."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"PNG writer takes uint8, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPES:
        raise ValueError(f"PNG writer takes 1 to 4 channels, not {c}")
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    data = z.compress(_filter_rows(img.reshape(h, w * c), c)) + z.flush()
    step = max(65536, 4 * w)
    head = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPES[c], 0, 0, 0)
    return b"".join([_SIGNATURE, _chunk(b"IHDR", head),
                     *(_chunk(b"IDAT", data[i:i + step])
                       for i in range(0, len(data), step)),
                     _chunk(b"IEND", b"")])


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# the filter types' predictor (a * _WA + b * _WB) >> _SH from the left (a)
# and upper (b) neighbours: None, Sub, Up, Average; Paeth apart
_WA = np.array([0, 1, 0, 1, 0], np.int16)
_WB = np.array([0, 0, 1, 1, 0], np.int16)
_SH = np.array([0, 0, 0, 1, 0], np.int16)


def _unfilter(filtered: np.ndarray, kinds: np.ndarray, w: int,
              bpp: int) -> np.ndarray:
    """Undo the row filters of B images of one size: filtered [B, h,
    w * bpp] uint8 and each row's filter type [B, h] -> [B, h, w, bpp]
    uint8. A pixel depends on its left, upper and upper-left neighbours, so
    the pixels of one anti-diagonal (x + y = d) of every image are
    reconstructed together, every filter type at once: h + w - 1 steps
    for the batch. The anti-diagonals are stored skewed (diagonal d + 2,
    row y + 1 holds pixel (y, d - y); row 0 and the slots left of x = 0
    stay 0), so each step reads its neighbours as slices."""
    B, h = kinds.shape
    n = h + w - 1
    ys, xs = np.mgrid[:h, :w]
    f = np.zeros((n, B, h, bpp), np.int16)
    f[ys + xs, :, ys] = filtered.reshape(B, h, w, bpp).transpose(1, 2, 0, 3)
    out = np.zeros((n + 2, B, h + 1, bpp), np.int16)
    kinds = kinds.astype(np.int64)
    wa, wb, sh = (t[kinds][..., None] for t in (_WA, _WB, _SH))
    paeth_row = (kinds == 4)[..., None]
    for d in range(n):
        y0, y1 = max(0, d - w + 1), min(h, d + 1)
        a = out[d + 1, :, y0 + 1:y1 + 1]      # (y, x - 1)
        b = out[d + 1, :, y0:y1]              # (y - 1, x)
        c = out[d, :, y0:y1]                  # (y - 1, x - 1)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(paeth_row[:, y0:y1], paeth,
                        (a * wa[:, y0:y1] + b * wb[:, y0:y1]) >> sh[:, y0:y1])
        out[d + 2, :, y0 + 1:y1 + 1] = (f[d, :, y0:y1] + pred) & 0xFF
    return out[ys + xs + 2, :, ys + 1].transpose(2, 0, 1, 3).astype(np.uint8)


def _chunks(data: bytes):
    """(kind, body) of each chunk of a PNG file's bytes."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            break


def _parse(data: bytes):
    """A PNG file's bytes -> (its filtered rows [h, 1 + w * bpp] uint8, w,
    bpp), refusing what `_unfilter` cannot read."""
    head, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if head is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = head
    if depth != 8 or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}")
    bpp = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * bpp)
    if (rows[:, 0] > 4).any():
        raise ValueError("PNG row with an unknown filter type")
    return rows, w, bpp


def decode_pngs(datas) -> list:
    """The bytes of 8-bit, non-interlaced grey, grey + alpha, RGB or RGBA
    PNGs -> [h, w, c] uint8 each, those of one shape unfiltered together."""
    parsed = [_parse(d) for d in datas]
    out = [None] * len(parsed)
    groups = {}
    for i, (rows, w, bpp) in enumerate(parsed):
        groups.setdefault((rows.shape, w, bpp), []).append(i)
    for (_, w, bpp), ids in groups.items():
        rows = np.stack([parsed[i][0] for i in ids])
        for i, img in zip(ids, _unfilter(rows[..., 1:], rows[..., 0], w,
                                         bpp)):
            out[i] = img
    return out


def read_pngs(paths) -> list:
    datas = []
    for path in paths:
        with open(path, "rb") as f:
            datas.append(f.read())
    return decode_pngs(datas)


def png_header(path: str):
    """(width, height, bit depth, colour type, interlace) of a PNG file,
    from its first 33 bytes."""
    with open(path, "rb") as f:
        data = f.read(33)
    kind, body = next(_chunks(data))
    if kind != b"IHDR" or len(body) != 13:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = struct.unpack(">IIBBBBB", body)
    return w, h, depth, color, interlace


def read_rgb(paths, wh) -> np.ndarray:
    """The PNGs at `paths` as float32 RGB in [0, 1] at wh = (w, h), [n, h,
    w, 3], as PIL's convert("RGB") and bilinear resize give them. PIL reads
    them where it imports. Where it does not, `read_pngs` reads 8-bit PNGs
    already at wh (PIL's resize to its own size is a copy), all of them in
    one pass, and any other image raises ImportError."""
    try:
        from PIL import Image
    except ImportError:
        return _read_rgb_in_tree(list(paths), tuple(wh))
    return np.stack([
        np.asarray(Image.open(p).convert("RGB").resize(
            tuple(wh), Image.BILINEAR), np.float32) / 255.0 for p in paths])


def _read_rgb_in_tree(paths, wh) -> np.ndarray:
    for p in paths:
        w, h, depth, color, interlace = png_header(p)
        if ((w, h) != wh or depth != 8 or color not in (0, 2, 4, 6)
                or interlace):
            raise ImportError(
                f"{p}: a {w}x{h} PNG of bit depth {depth}, colour type "
                f"{color}, interlace {interlace} needs PIL to be read at "
                f"{wh[0]}x{wh[1]}")
    # the colour channels (alpha dropped), grey repeated: convert("RGB")
    rgb = [np.broadcast_to(img[..., :3] if img.shape[2] >= 3
                           else img[..., :1], img.shape[:2] + (3,))
           for img in read_pngs(paths)]
    return np.stack(rgb).astype(np.float32) / 255.0


def save_png(path: str, img: np.ndarray) -> None:
    """img [h, w] or [h, w, 1-4] uint8 as a PNG file: through PIL where it
    imports, else through `write_png` (PIL's bytes)."""
    try:
        from PIL import Image
    except ImportError:
        write_png(path, img)
        return
    Image.fromarray(img).save(path)
