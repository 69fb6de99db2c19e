"""The spiral video: mp4 through cv2, else an AVI written by hand
(counterpart of ``gscream_tpu/utils/video.py``).

The reference pipes the spiral renders through ffmpeg into an mp4
(train.py:844-846).  The order is the JAX package's: cv2's mp4v encoder
first, then MJPEG frames (JPEG by imageio) in an AVI container muxed
here.  The one deliberate difference: where neither cv2 nor imageio
imports (the card's machine has neither), the same AVI structure holds
lossless PNG frames, made by the port's PNG writer, under the fourcc
``MPNG``.  Its cause is the installation, not the format.  Only what
the stream needs is written: RIFF/AVI, hdrl (avih and one strl with
strh and strf), movi with ``00dc`` chunks, idx1.
"""
from __future__ import annotations

import io
import struct
from typing import Iterable, List

import numpy as np

from .png import encode_png


def _u8(frame: np.ndarray) -> np.ndarray:
    if frame.dtype == np.uint8:
        return frame
    return (np.clip(frame, 0, 1) * 255).astype(np.uint8)


def _jpeg_bytes(frame: np.ndarray, quality: int) -> bytes:
    import imageio.v2 as imageio
    buf = io.BytesIO()
    imageio.imwrite(buf, _u8(frame), format="jpeg", quality=quality)
    return buf.getvalue()


def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    pad = b"\x00" if len(payload) % 2 else b""
    return fourcc + struct.pack("<I", len(payload)) + payload + pad


def _list(fourcc: bytes, payload: bytes) -> bytes:
    return _chunk(b"LIST", fourcc + payload)


def write_avi(path: str, encoded: List[bytes], width: int, height: int,
              fps: int, fourcc: bytes) -> int:
    """Mux already-encoded frames into an AVI; returns the frame count."""
    if not encoded:
        return 0
    n = len(encoded)
    max_size = max(len(j) for j in encoded)
    avih = struct.pack(
        "<IIIIIIIIIIIIII",
        int(1e6 // fps),        # microseconds per frame
        max_size * fps,         # max bytes per second (upper bound)
        0,                      # padding granularity
        0x10,                   # flags: AVIF_HASINDEX
        n, 0,                   # total frames, initial frames
        1,                      # streams
        max_size,               # suggested buffer size
        width, height, 0, 0, 0, 0)
    strh = struct.pack(
        "<4s4sIHHIIIIIIIIhhhh",
        b"vids", fourcc,
        0,                      # dwFlags
        0, 0,                   # wPriority, wLanguage
        0,                      # dwInitialFrames
        1, fps,                 # dwScale, dwRate → fps frames/s
        0, n,                   # dwStart, dwLength (frames)
        max_size,               # dwSuggestedBufferSize
        0xFFFFFFFF, 0,          # dwQuality (-1 = default), dwSampleSize
        0, 0, width & 0x7FFF, height & 0x7FFF)   # rcFrame l,t,r,b
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _list(b"hdrl", _chunk(b"avih", avih)
                 + _list(b"strl", _chunk(b"strh", strh)
                         + _chunk(b"strf", strf)))
    movi_chunks, idx, offset = [], [], 4   # offsets start after 'movi'
    for j in encoded:
        ch = _chunk(b"00dc", j)
        movi_chunks.append(ch)
        idx.append(struct.pack("<4sIII", b"00dc", 0x10, offset, len(j)))
        offset += len(ch)
    body = (b"AVI " + hdrl + _list(b"movi", b"".join(movi_chunks))
            + _chunk(b"idx1", b"".join(idx)))
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return n


def write_mjpeg_avi(path: str, frames: Iterable[np.ndarray],
                    fps: int = 30, quality: int = 90) -> int:
    """(H,W,3) float [0,1] / uint8 frames as MJPEG AVI (needs imageio)."""
    frames = list(frames)
    if not frames:
        return 0
    h, w = frames[0].shape[:2]
    return write_avi(path, [_jpeg_bytes(f, quality) for f in frames], w, h,
                     fps, b"MJPG")


def write_png_avi(path: str, frames: Iterable[np.ndarray],
                  fps: int = 30) -> int:
    """(H,W,3) float [0,1] / uint8 frames as lossless PNG frames in an AVI
    (fourcc ``MPNG``), with the standard library only."""
    frames = list(frames)
    if not frames:
        return 0
    h, w = frames[0].shape[:2]
    return write_avi(path, [encode_png(np.ascontiguousarray(_u8(f)))
                            for f in frames], w, h, fps, b"MPNG")


def avi_frames(path: str) -> List[bytes]:
    """The ``00dc`` payloads of an AVI this module wrote, in order."""
    with open(path, "rb") as f:
        data = f.read()
    at = data.index(b"movi")               # LIST <size> movi <chunks>
    end = at + struct.unpack("<I", data[at - 4:at])[0]
    out, pos = [], at + 4
    while pos < end:
        tag, n = struct.unpack("<4sI", data[pos:pos + 8])
        if tag == b"00dc":
            out.append(data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    return out


def _write_mp4(path: str, frames: List[np.ndarray], fps: int) -> bool:
    try:
        import cv2
    except ImportError:
        return False
    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if not vw.isOpened():
        return False
    for f in frames:
        vw.write(np.ascontiguousarray(_u8(f)[..., ::-1]))   # RGB → BGR
    vw.release()
    return True


def write_video(path_base: str, frames, fps: int = 30) -> str:
    """The spiral video: ``<path_base>.mp4`` through cv2, else
    ``<path_base>.avi`` with MJPEG frames through imageio, else with PNG
    frames.  Returns the path written ("" for no frames)."""
    frames = list(frames)
    if not frames:
        return ""
    if _write_mp4(path_base + ".mp4", frames, fps):
        return path_base + ".mp4"
    out = path_base + ".avi"
    try:
        import imageio.v2  # noqa: F401
    except ImportError:
        write_png_avi(out, frames, fps)
    else:
        write_mjpeg_avi(out, frames, fps)
    return out
