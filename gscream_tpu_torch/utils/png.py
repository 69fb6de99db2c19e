"""PNG encoding and decoding with the standard library only.

The card's machine has no imageio, Pillow or cv2, so the port writes
its 8-bit RGB PNGs itself (filter type 0 on every row, one zlib stream)
and, where imageio does not import, reads them back here.  The reader
takes 8-bit, non-interlaced grey, RGB and RGBA images whose rows use
filter types 0-2 (what this module and common encoders write for such
images); anything else needs imageio.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}      # colour type → channels


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """(H,W,3) uint8 → the bytes of an 8-bit RGB PNG."""
    h, w, _ = rgb_u8.shape
    raw = b"".join(b"\x00" + rgb_u8[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb_u8))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H,W,C) uint8 (see the module docstring for what it
    takes)."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}); install imageio")
    c = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + w * c)
    out = np.empty((h, w * c), np.uint8)
    prior = np.zeros(w * c, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            out[y] = line
        elif kind == 1:      # Sub: a running sum per channel, mod 256
            out[y] = np.cumsum(line.reshape(w, c), 0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:      # Up
            out[y] = line + prior
        else:
            raise ValueError(f"PNG filter type {kind} is not supported "
                             "here; install imageio")
        prior = out[y]
    return out.reshape(h, w, c)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
