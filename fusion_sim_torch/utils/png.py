"""PNG encoding for frame streaming (port of ``fusion_sim_tpu/utils/png.py``).

The native path is the repository's ``native/png_encoder.cpp`` (adaptive
none/sub/up scanline filters + zlib), loaded through ``ctypes`` and built
with ``make -C native`` the first time it is needed; the fallback writes
filter-0 scanlines with Python's zlib.  Both produce standard PNGs.
``decode_png`` reads back what either encoder writes.
"""

from __future__ import annotations

import ctypes
import functools
import os
import struct
import subprocess
import threading
import zlib

import numpy as np

_NATIVE_DIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                           "..", "native"))
_LIB_PATH = os.path.join(_NATIVE_DIR, "libfspng.so")
_LOAD_LOCK = threading.Lock()   # one build, whichever thread asks first
_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@functools.lru_cache(maxsize=1)
def _load_native_once():
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return None
    lib.fspng_encode_rgb.restype = ctypes.c_size_t
    lib.fspng_encode_rgb.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
    ]
    return lib


def _load_native():
    with _LOAD_LOCK:
        return _load_native_once()


def _encode_python(rgb: np.ndarray, level: int) -> bytes:
    h, w = rgb.shape[:2]
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1).tobytes()
    idat = zlib.compress(raw, level)
    out = [_SIGNATURE]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    out.append(chunk(b"IHDR", ihdr))
    out.append(chunk(b"IDAT", idat))
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def encode_png(rgb: np.ndarray, level: int = 3) -> bytes:
    """Encode an (h, w, 3) uint8 array as PNG bytes."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (h, w, 3) uint8, got {rgb.shape}")
    lib = _load_native()
    if lib is not None:
        h, w = rgb.shape[:2]
        cap = rgb.nbytes + 4096
        out = (ctypes.c_uint8 * cap)()
        n = lib.fspng_encode_rgb(
            rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), w, h,
            level, out, cap)
        if n:
            return bytes(bytearray(out[:n]))
    return _encode_python(rgb, level)


def native_available() -> bool:
    return _load_native() is not None


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit RGB, non-interlaced PNG with scanline filters 0-2
    (what both encoders write) to an (h, w, 3) uint8 array; anything else
    raises ValueError."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + length
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"not an 8-bit RGB non-interlaced PNG: {header}")
    w, h = header[0], header[1]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + 3 * w):
        raise ValueError(f"{raw.size} bytes of image data for {h} x {w}")
    rows = raw.reshape(h, 1 + 3 * w)
    out = np.empty((h, 3 * w), np.uint8)
    prev = np.zeros(3 * w, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:   # sub: running sum of each channel, mod 256
            cur = np.cumsum(line.reshape(w, 3), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:   # up
            cur = line + prev
        else:
            raise ValueError(f"scanline filter {kind} in row {y}")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, 3)
