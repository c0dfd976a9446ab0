"""ctypes bindings for the native host runtime (csrc/deflate_runtime.cpp).

Builds the shared library on first use (g++ is in the image; pybind11 is
not, so the ABI is plain C + ctypes per the build constraints).  Every entry
point has a NumPy/stdlib fallback — the native path accelerates the host-side
serial tail (ordered assembly, bit splicing, verification checksums), it is
never required for correctness.  A failed build or load warns once, and
:func:`available` reports it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
import zlib

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "csrc", "deflate_runtime.cpp")
_LIB_PATH = os.path.join(os.path.dirname(_SRC), "libdeflate_runtime.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        # Benign race: _tried/_lib each transition exactly once; the fast
        # path keeps per-call lock traffic off the streaming hot path.
        return _lib
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_LIB_PATH) or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC):
                # Compile to a private temp path, then atomically rename:
                # concurrent processes (multi-host runs on one machine) must
                # never dlopen a half-written .so.
                tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _LIB_PATH)
            lib = ctypes.CDLL(_LIB_PATH)
            lib.assemble_chunks.restype = ctypes.c_int64
            lib.assemble_chunks.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.bit_append.restype = ctypes.c_int64
            lib.bit_append.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ]
            lib.crc32_raw.restype = ctypes.c_uint32
            lib.crc32_raw.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
            lib.adler32.restype = ctypes.c_uint32
            lib.adler32.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32]
            _lib = lib
        except Exception as e:  # noqa: BLE001
            _lib = None
            warnings.warn(
                f"native host runtime unavailable ({type(e).__name__}: {e}); "
                "using the NumPy/stdlib fallbacks", RuntimeWarning, stacklevel=2,
            )
        return _lib


def available() -> bool:
    return _load() is not None


def assemble_chunks(words: np.ndarray, nbytes: np.ndarray) -> bytes:
    """Concatenate per-chunk payloads. words: uint8[n_chunks, stride]."""
    lib = _load()
    if words.dtype != np.uint8 or words.ndim != 2:
        # The C side measures stride in BYTES; a uint32 view passed by
        # mistake would validate against an element count and read rows at
        # 1/4 the real stride — silently garbled output.
        raise TypeError(f"words must be uint8[n_chunks, stride], got {words.dtype}{words.shape}")
    nbytes = np.ascontiguousarray(nbytes, np.int64)
    if nbytes.shape != (words.shape[0],):
        raise ValueError(f"nbytes shape {nbytes.shape} != ({words.shape[0]},)")
    if nbytes.size and (int(nbytes.max()) > words.shape[1] or int(nbytes.min()) < 0):
        raise ValueError(
            f"chunk byte count out of range for stride {words.shape[1]}: "
            f"{int(nbytes.min())}..{int(nbytes.max())}"
        )
    total = int(nbytes.sum())
    if lib is None:
        return b"".join(
            words[i, : int(nbytes[i])].tobytes() for i in range(words.shape[0])
        )
    out = np.empty(total, np.uint8)
    words = np.ascontiguousarray(words)
    rc = lib.assemble_chunks(
        out.ctypes.data, words.ctypes.data, words.shape[1], nbytes.ctypes.data,
        words.shape[0],
    )
    if rc != 0:
        raise ValueError("assemble_chunks: chunk byte count out of range (native)")
    return out.tobytes()


def bit_append(dst: bytearray, dst_bits: int, src: bytes, src_bits: int) -> int:
    """Append src's bit string onto dst (LSB-first); returns new bit length.

    dst must be pre-sized to hold the result plus one spare byte.
    """
    lib = _load()
    if lib is not None:
        buf = (ctypes.c_char * len(dst)).from_buffer(dst)
        return int(lib.bit_append(buf, dst_bits, src, src_bits))
    # Python fallback.  Iterate ceil(src_bits/8) bytes exactly like the C
    # path — src may be longer than its bit count implies, and copying the
    # excess would break the zero-above-end invariant.
    shift = dst_bits & 7
    pos = dst_bits >> 3
    nsrc = (src_bits + 7) >> 3
    if shift == 0:
        dst[pos : pos + nsrc] = src[:nsrc]
    else:
        carry = dst[pos] & ((1 << shift) - 1)
        for i in range(nsrc):
            v = (src[i] << shift) | carry
            dst[pos + i] = v & 0xFF
            carry = v >> 8
        dst[pos + nsrc] = carry
    return dst_bits + src_bits


def crc32(data: bytes, value: int = 0) -> int:
    lib = _load()
    if lib is None:
        return zlib.crc32(data, value)
    return int(lib.crc32_raw(data, len(data), value ^ 0xFFFFFFFF)) ^ 0xFFFFFFFF


def adler32(data: bytes, value: int = 1) -> int:
    lib = _load()
    if lib is None:
        return zlib.adler32(data, value)
    return int(lib.adler32(data, len(data), value))
