"""Image files in numpy and the standard library's `zlib`: the decoder the
port falls back on where the native loader (`csrc/frameloader.cpp`) does
not build, and the PNG writer of its overlays and test folders.

The decoder repeats the native one step for step (formats, checks, and
the float32 operations in their order), so the two agree byte for byte:

* PNG: 8- or 16-bit gray, gray + alpha, RGB or RGBA, not interlaced, all
  five row filters; an IDAT that inflates past the size IHDR declares is
  refused before it is held in memory.  Filters 0-2 are unfiltered a row
  at a time in numpy; Average and Paeth run byte by byte in Python (about
  a second for a 480x640 RGB frame that uses them throughout).
* PGM/PPM (P5/P6, 8 or 16 bit, big-endian samples), and .npy 2-D arrays of
  little-endian float32, uint16 or uint8.

Colour becomes Rec. 601 luminance, (0.299 R + 0.587 G) + 0.114 B.  With
scale == 0 samples are normalised by the format's maximum (floats pass
as they are), otherwise multiplied by `scale` (1/5000 for TUM depth).
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

_F = np.float32
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_SPACE = b" \t\n\v\f\r"


class DecodeError(ValueError):
    """The file is not an image this decoder reads."""


def _luma(r, g, b) -> np.ndarray:
    return (_F(0.299) * r + _F(0.587) * g) + _F(0.114) * b


def _inv(scale: float, maxv: int) -> np.float32:
    return _F(scale) if scale > 0 else _F(1.0) / _F(maxv)


def _atoi(tok: bytes) -> int:
    m = re.match(rb"\s*([+-]?\d+)", tok)
    return int(m.group(1)) if m else 0


def _pnm_token(b: bytes, pos: int) -> tuple[int, bytes]:
    n = len(b)
    while pos < n:
        if b[pos] == ord("#"):
            while pos < n and b[pos] != ord("\n"):
                pos += 1
        elif b[pos] in _SPACE:
            pos += 1
        else:
            break
    start = pos
    while pos < n and b[pos] not in _SPACE and b[pos] != ord("#"):
        pos += 1
    return pos, b[start:pos]


def _decode_pnm(b: bytes, scale: float) -> np.ndarray:
    if len(b) < 10 or b[0] != ord("P") or b[1] not in b"56":
        raise DecodeError("not a P5/P6 file")
    pos, tok = _pnm_token(b, 2)
    w = _atoi(tok)
    pos, tok = _pnm_token(b, pos)
    h = _atoi(tok)
    pos, tok = _pnm_token(b, pos)
    maxv = _atoi(tok)
    if w <= 0 or h <= 0 or maxv <= 0:
        raise DecodeError("bad PNM header")
    pos += 1                                # one whitespace after maxval
    ch = 3 if b[1] == ord("6") else 1
    nb = 2 if maxv > 255 else 1
    need = w * h * ch * nb
    if len(b) < pos + need:
        raise DecodeError("truncated PNM data")
    s = np.frombuffer(b, ">u2" if nb == 2 else np.uint8, w * h * ch, pos).astype(_F)
    s = s.reshape(h, w, ch)
    v = _luma(s[..., 0], s[..., 1], s[..., 2]) if ch == 3 else s[..., 0]
    return v * _inv(scale, maxv)


def _npy_val(hdr: str, key: str) -> str:
    p = hdr.find(key)
    if p < 0:
        return ""
    p = hdr.find(":", p)
    e = hdr.find(",", p)
    return hdr[p + 1:] if e < 0 else hdr[p + 1:e]


def _decode_npy(b: bytes, scale: float) -> np.ndarray:
    if len(b) < 10 or b[:6] != b"\x93NUMPY":
        raise DecodeError("not a .npy file")
    hlen = b[8] | (b[9] << 8)
    hdr = b[10:10 + hlen].decode("latin-1")
    descr = _npy_val(hdr, "'descr'")
    if ">" in descr or "True" in _npy_val(hdr, "'fortran_order'"):
        raise DecodeError("big-endian or Fortran-ordered .npy")
    sp = hdr.find("(", hdr.find("'shape'"))
    m = re.match(r"\(\s*([+-]?\d+),\s*([+-]?\d+)", hdr[sp:])
    if sp < 0 or m is None:
        raise DecodeError("not a 2-D .npy array")
    h, w = int(m.group(1)), int(m.group(2))
    npix = h * w
    off = 10 + hlen
    avail = len(b) - off
    if "f4" in descr and avail >= npix * 4:
        a, s = np.frombuffer(b, "<f4", npix, off), _F(scale) if scale > 0 else _F(1.0)
    elif "u2" in descr and avail >= npix * 2:
        a, s = np.frombuffer(b, "<u2", npix, off).astype(_F), _inv(scale, 65535)
    elif "u1" in descr and avail >= npix:
        a, s = np.frombuffer(b, np.uint8, npix, off).astype(_F), _inv(scale, 255)
    else:
        raise DecodeError(f"unsupported .npy dtype {descr.strip()}")
    return (a * s).reshape(h, w)


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    rows = raw.reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    up = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = int(rows[y, 0])
        src = rows[y, 1:]
        if ft == 0:
            cur = src
        elif ft == 1:
            cur = (np.cumsum(src.reshape(-1, bpp).astype(np.int64), 0) & 0xFF
                   ).astype(np.uint8).reshape(-1)
        elif ft == 2:
            cur = src + up
        elif ft in (3, 4):
            s, u, out = src.tolist(), up.tolist(), [0] * stride
            for x in range(stride):
                a = out[x - bpp] if x >= bpp else 0
                if ft == 3:
                    out[x] = (s[x] + ((a + u[x]) >> 1)) & 0xFF
                else:
                    c = u[x - bpp] if x >= bpp else 0
                    p = a + u[x] - c
                    pa, pb, pc = abs(p - a), abs(p - u[x]), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else (u[x] if pb <= pc else c)
                    out[x] = (s[x] + pred) & 0xFF
            cur = np.asarray(out, np.uint8)
        else:
            raise DecodeError(f"PNG row filter {ft}")
        img[y] = cur
        up = img[y]
    return img


def _decode_png(b: bytes, scale: float) -> np.ndarray:
    if len(b) < 8 + 25 or b[:8] != _PNG_SIG:
        raise DecodeError("not a PNG file")
    pos, w, h, depth, ctype, interlace, idat = 8, 0, 0, 0, -1, 0, []
    while pos + 12 <= len(b):
        (n,) = struct.unpack_from(">I", b, pos)
        if pos + 12 + n > len(b):
            raise DecodeError("truncated PNG chunk")
        tag, data = b[pos + 4:pos + 8], b[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            if n < 13:
                raise DecodeError("short IHDR")
            w, h = struct.unpack_from(">II", data)
            depth, ctype, interlace = data[8], data[9], data[12]
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if w <= 0 or h <= 0 or w * h > (1 << 28) or interlace != 0:
        raise DecodeError("unsupported PNG size or interlace")
    if depth not in (8, 16):
        raise DecodeError(f"PNG bit depth {depth}")
    ch = {0: 1, 2: 3, 4: 2, 6: 4}.get(ctype)
    if ch is None:
        raise DecodeError(f"PNG colour type {ctype}")
    bpp = ch * depth // 8
    stride = w * bpp
    expected = (stride + 1) * h
    z = zlib.decompressobj()
    try:
        raw = z.decompress(b"".join(idat), expected + 1)
    except zlib.error as e:
        raise DecodeError(f"bad IDAT stream: {e}") from None
    if len(raw) > expected or not z.eof or len(raw) < expected:
        raise DecodeError("IDAT does not inflate to the declared size")
    img = _unfilter(np.frombuffer(raw, np.uint8), h, stride, bpp).reshape(h, w, ch, depth // 8)
    s = img[..., 0].astype(_F) if depth == 8 else (
        img[..., 0].astype(np.uint16) << 8 | img[..., 1]).astype(_F)
    v = _luma(s[..., 0], s[..., 1], s[..., 2]) if ch >= 3 else s[..., 0]
    return v * _inv(scale, 65535 if depth == 16 else 255)


def decode_bytes(b: bytes, scale: float = 0.0) -> np.ndarray:
    """Decode one file's bytes to float32 [H, W] (PNG, then PNM, then
    .npy, as the native decoder tries them)."""
    for fn in (_decode_png, _decode_pnm, _decode_npy):
        try:
            return np.ascontiguousarray(fn(b, scale), dtype=_F)
        except DecodeError:
            continue
    raise DecodeError("not a PNG, PGM/PPM or .npy image")


def decode_file(path: str, scale: float = 0.0) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_bytes(f.read(), scale)


def encode_png(arr: np.ndarray, filters=2, level: int = 6) -> bytes:
    """PNG bytes of uint8 [H, W] (gray), uint16 [H, W] (16-bit gray) or
    uint8 [H, W, 3] (RGB).  `filters`: one row filter type 0-4 for every
    row, or a list of one a row."""
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.dtype == np.uint16:
        depth, ctype, bpp, raw = 16, 0, 2, arr.astype(">u2").tobytes()
    elif arr.ndim == 2 and arr.dtype == np.uint8:
        depth, ctype, bpp, raw = 8, 0, 1, arr.tobytes()
    elif arr.ndim == 3 and arr.shape[2] == 3 and arr.dtype == np.uint8:
        depth, ctype, bpp, raw = 8, 2, 3, arr.tobytes()
    else:
        raise ValueError(f"encode_png takes uint8/uint16 gray or uint8 RGB, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    stride = w * bpp
    fts = [filters] * h if isinstance(filters, int) else list(filters)
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride).astype(np.int32)
    prev = np.zeros(stride, np.int32)
    out = np.empty((h, stride + 1), np.uint8)
    for y in range(h):
        cur = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        ft = fts[y]
        if ft == 0:
            enc = cur
        elif ft == 1:
            enc = cur - a
        elif ft == 2:
            enc = cur - prev
        elif ft == 3:
            enc = cur - (a + prev) // 2
        elif ft == 4:
            p = a + prev - c
            pa, pb, pc = np.abs(p - a), np.abs(p - prev), np.abs(p - c)
            enc = cur - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, prev, c))
        else:
            raise ValueError(f"PNG row filter {ft}")
        out[y, 0] = ft
        out[y, 1:] = enc & 0xFF
        prev = cur

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (_PNG_SIG + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(out.tobytes(), level)) + chunk(b"IEND", b""))


def write_png(path: str, arr: np.ndarray, filters=2) -> None:
    """Write `arr` as a PNG file (see `encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(arr, filters))
