"""Build, load and launch the port's CUDA kernels.

All of wah_tpu_torch/csrc/*.cu is compiled by nvcc for sm_90a into one
shared library with a plain C interface and loaded with ctypes (no
PyTorch headers: a build takes seconds, not minutes). Each source is
compiled by its own nvcc process, all started together, and the objects
are linked by one more. The build happens at first use, into
wah_tpu_torch/_build/ (git-ignored), under a name keyed on a hash of the
sources and flags, so an edited source rebuilds and an unchanged one
loads at once. nvcc's output, with ptxas's register and shared-memory
report, is kept beside the library as a .log file. A failed build raises
with nvcc's output; nothing falls back to the plain versions.

Every C entry takes device pointers and the CUDA stream as void*, sizes
as int (a stream's length, which may pass 2^31, as long long), and
returns cudaGetLastError() after its launch.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_N = ctypes.c_int
_L = ctypes.c_longlong
# C entry -> argument types; every entry ends with the stream
_SIGNATURES = {
    "wah_encode_tiles": [_P, _P, _P, _P, _N, _P],
    "wah_encode_fused": [_P, _P, _P, _P, _P, _N, _N, _P],
    "wah_stitch_tiles": [_P, _P, _P, _P, _N, _P],
    "wah_stitch_gather": [_P, _P, _P, _N, _P],
    "wah_prescan_words": [_P, _P, _P, _P, _N, _N, _P],
    "wah_decode_blocks": [_P, _P, _P, _P, _N, _N, _P],
    "wah_rows_scan": [_P, _P, _P, _P, _P, _N, _N, _N, _N, _P],
    "wah_check_stream": [_P, _L, _P, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libwah_tpu_torch_kernels-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{lib.stem}.{os.getpid()}"
    objs, compiles = [], []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objs.append(obj)
        compiles.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, proc in compiles:
        out = proc.communicate()[0]
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode:
            failed.append(out)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"$ {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        if res.returncode:
            failed.append(res.stdout + res.stderr)
    lib.with_suffix(".log").write_text("".join(log))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, lib)


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built first if its sources changed."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.wah_error_string.argtypes = [ctypes.c_int]
    lib.wah_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry `name` on `device`'s current stream; raise if the launch
    reported a CUDA error."""
    lib = load()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.wah_error_string(err).decode()}")

