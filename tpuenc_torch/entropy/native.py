"""ctypes binding to the repository's native entropy library.

Counterpart of ``tpuenc/entropy/native.py``.  The port needs two
functions of ``native/entropy.cpp`` on its path: ``tpuenc_realign_segments``,
which turns the device's bit-granular scan stream into finished scan bytes
(per restart segment: shift to a byte boundary, 1-pad the tail,
0xFF-stuff, insert RST markers), and ``tpuenc_build_k2``, the Annex K.2
table build of the two-pass optimized-table mode.

The library is built with g++ from the unchanged ``native/entropy.cpp``
into the port's own build directory (``tpuenc_torch/_build``), under a
name keyed on a hash of the source, written to a temporary file and
renamed into place so that concurrent processes never load a half-written
file.  A failed build or load raises: the port has no silent switch to
the Python oracle, :func:`realign_segments_py`, which stays as the test
reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "entropy.cpp")
BUILD_DIR = os.path.join(_REPO, "tpuenc_torch", "_build")

_lock = threading.Lock()
_lib = None


def _build(src: str, out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-pthread", "-o", tmp, src]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"building {src} failed ({res.returncode}):\n{res.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with open(_SRC, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        path = os.path.join(BUILD_DIR, f"libtpuenc_entropy-{digest}.so")
        if not os.path.exists(path):
            _build(_SRC, path)
        lib = ctypes.CDLL(path)
        lib.tpuenc_realign_segments.restype = ctypes.c_longlong
        lib.tpuenc_realign_segments.argtypes = [
            ctypes.c_void_p,   # in bytes (bit-granular stream)
            ctypes.c_void_p,   # seg_bits int64*
            ctypes.c_longlong, # n_segs
            ctypes.c_int,      # num_threads
            ctypes.c_void_p,   # out
            ctypes.c_longlong, # out capacity
            ctypes.c_int,      # skip_first (segment 0 = offset, not emitted)
        ]
        lib.tpuenc_build_k2.restype = ctypes.c_int32
        lib.tpuenc_build_k2.argtypes = [
            ctypes.c_void_p,   # freq int64 (257,)
            ctypes.c_void_p,   # lengths out uint8 (16,)
            ctypes.c_void_p,   # values out uint8 (256,)
        ]
        _lib = lib
        return _lib


def realign_segments(data: bytes, seg_bits, bit_offset: int = 0) -> bytes:
    """Assemble a scan from a bit-granular stream: per restart segment,
    shift to byte alignment, 1-pad the tail, 0xFF-stuff and insert RST
    markers.  ``seg_bits`` holds per-segment BIT lengths; segment s starts
    at bit ``bit_offset + sum(seg_bits[:s])``."""
    lib = _load()
    seg_bits = np.ascontiguousarray(seg_bits, dtype=np.int64)
    if bit_offset:
        seg_bits = np.concatenate([[bit_offset], seg_bits])
    buf = np.frombuffer(data, dtype=np.uint8)
    need = -(-int(seg_bits.sum()) // 8)
    if buf.size < need:
        raise ValueError(f"stream holds {buf.size} bytes, segments need {need}")
    total_bytes = int(seg_bits.sum()) // 8 + len(seg_bits)
    cap = 2 * total_bytes + 2 * len(seg_bits) + 16
    out = np.empty(cap, dtype=np.uint8)
    n = lib.tpuenc_realign_segments(
        buf.ctypes.data_as(ctypes.c_void_p),
        seg_bits.ctypes.data_as(ctypes.c_void_p),
        len(seg_bits),
        os.cpu_count() or 1,
        out.ctypes.data_as(ctypes.c_void_p),
        cap,
        1 if bit_offset else 0,
    )
    if n < 0:
        raise RuntimeError(f"tpuenc_realign_segments failed ({n})")
    return out[:n].tobytes()


def build_k2(freq: np.ndarray):
    """Native Annex K.2 table build from a 257-bin histogram (bin 256 is
    the reserved symbol).  Returns ``(lengths[16], values)``, or None when
    the native build reports a degenerate histogram (``n < 0``); the
    caller then runs the Python build, as ``tpuenc`` does."""
    lib = _load()
    freq = np.ascontiguousarray(freq, dtype=np.int64)
    if freq.shape != (257,):
        raise ValueError(f"expected a 257-bin histogram, got {freq.shape}")
    lengths = np.zeros(16, dtype=np.uint8)
    values = np.zeros(256, dtype=np.uint8)
    n = lib.tpuenc_build_k2(
        freq.ctypes.data, lengths.ctypes.data, values.ctypes.data
    )
    if n < 0:
        return None
    return lengths.tolist(), values[:n].tolist()


def realign_segments_py(data: bytes, seg_bits, bit_offset: int = 0) -> bytes:
    """Pure-Python oracle of :func:`realign_segments` (tests only)."""
    out = bytearray()
    bit_off = bit_offset
    for s, nbits in enumerate(seg_bits):
        nbits = int(nbits)
        if s > 0:
            out += bytes((0xFF, 0xD0 + ((s - 1) & 7)))
        # Extract bits [bit_off, bit_off + nbits) from the stream.
        b0 = bit_off >> 3
        b1 = (bit_off + nbits + 7) >> 3
        window = int.from_bytes(data[b0:b1], "big")
        win_bits = (b1 - b0) * 8
        drop = win_bits - (bit_off & 7) - nbits
        seg = (window >> drop) & ((1 << nbits) - 1) if nbits else 0
        pad = (-nbits) % 8
        seg = (seg << pad) | ((1 << pad) - 1)
        raw = seg.to_bytes((nbits + pad) // 8, "big")
        out += raw.replace(b"\xff", b"\xff\x00")
        bit_off += nbits
    return bytes(out)
