"""ctypes bindings for the native C++ host codec
(wah_tpu_torch/csrc_host/wah_core.cpp) — the port's copy of
wah_tpu/native.py.

A scalar CPU WAH codec for stream validation, for cross-checking the
device kernels in the differential, and for the CLI's --native codec.
Built at first use (g++ -O3) into wah_tpu_torch/_build/ (git-ignored)
under a name keyed on a hash of the source. A caller that needs the codec
gets the build's error if it fails; `available()` only probes.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "encode",
    "decode",
    "decoded_chunks",
    "validate",
    "chunk_count",
]

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc_host" / "wah_core.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64 = ctypes.c_int64


@functools.cache
def _get() -> ctypes.CDLL:
    """The host library, built first if its source changed. Raises
    RuntimeError if g++ is missing or fails."""
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"libwah_core-{h}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"native codec: g++ not found ({e})") from e
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"native codec: g++ failed:\n{e.stdout}{e.stderr}") from e
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, restype, argtypes in (
        ("wah_chunk_count", _i64, [_i64]),
        ("wah_encode", _i64, [_u32p, _i64, _u32p]),
        ("wah_decoded_chunks", _i64, [_u32p, _i64]),
        ("wah_decode", _i64, [_u32p, _i64, _u32p, _i64]),
        ("wah_validate", ctypes.c_int32, [_u32p, _i64]),
    ):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def available() -> bool:
    """True if the host library can be built and loaded here."""
    try:
        _get()
    except RuntimeError:
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u32p)


def chunk_count(n_ints: int) -> int:
    return int(_get().wah_chunk_count(n_ints))


def encode(ints: np.ndarray) -> np.ndarray:
    """Compress a uint32 bitmap -> WAH stream (native CPU path)."""
    ints = np.ascontiguousarray(ints, dtype=np.uint32)
    lib = _get()
    cap = int(lib.wah_chunk_count(ints.shape[0]))
    out = np.empty(max(cap, 1), dtype=np.uint32)
    n = int(lib.wah_encode(_ptr(ints), ints.shape[0], _ptr(out)))
    return out[:n].copy()


def decoded_chunks(words: np.ndarray) -> int:
    words = np.ascontiguousarray(words, dtype=np.uint32)
    n = int(_get().wah_decoded_chunks(_ptr(words), words.shape[0]))
    if n < 0:
        raise ValueError("invalid WAH stream: zero-length fill")
    return n


def decode(words: np.ndarray, out_ints: int | None = None) -> np.ndarray:
    """Decompress a WAH stream -> uint32 bitmap (native CPU path)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    lib = _get()
    nc = decoded_chunks(words)
    full = (31 * nc + 31) // 32
    cap = full if out_ints is None else out_ints
    out = np.empty(max(cap, 1), dtype=np.uint32)
    n = int(lib.wah_decode(_ptr(words), words.shape[0], _ptr(out), cap))
    if n < 0:
        raise ValueError("invalid WAH stream")
    return out[:cap] if out_ints is not None else out[:n]


def validate(words: np.ndarray) -> None:
    """Raise ValueError on format violations (native fast path of
    api.validate_stream)."""
    words = np.ascontiguousarray(words, dtype=np.uint32)
    rc = int(_get().wah_validate(_ptr(words), words.shape[0]))
    if rc == 1:
        raise ValueError("invalid WAH stream: contains literal-fill word")
    if rc == 2:
        raise ValueError("invalid WAH stream: fill length out of range")
