"""Build and load the port's CUDA kernels (``csrc/*.cu``) at first use.

The sources are compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared
library with a plain C interface and loaded with ``ctypes``; nothing includes
PyTorch's headers, so the build takes seconds. The library lands in
``cadm_tpu_torch/_build/`` (git-ignored) under a name that carries a hash of
the sources, so an edited kernel is rebuilt and a stale one never loads.

Every C entry point launches on the stream it is given, allocates nothing,
and returns ``cudaGetLastError()`` after its launch; ``check`` turns a
non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("pgs.cu", "full_dyn.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures of the entry points (see csrc/*.cu)
_SIGNATURES = {
    # A, b, vstar, actmu, lam0, lam_out, E, nc, iters, stream
    "cadm_pgs": [_P] * 6 + [_I] * 3 + [_P],
    # table, qpos, qvel, ctrl, mass_scale, damping_scale, act_mask, out,
    # E, out_stride, stream
    "cadm_full_dyn": [_P] * 8 + [_I] * 2 + [_P],
    # sizeof(SysTable), to check the host mirror's layout
    "cadm_sys_table_bytes": [],
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: nvcc is needed to build "
                           "the cadm_tpu_torch kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return os.path.join(BUILD_DIR, f"libcadm_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the kernels unless this exact build exists; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC, s) for s in SOURCES)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{e.stderr}") from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.cadm_error_string.argtypes = [ctypes.c_int]
            handle.cadm_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        msg = lib().cadm_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")


def stream_handle(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as a pointer-sized int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_f32(what: str, *tensors: torch.Tensor) -> None:
    """Validate kernel inputs: float32, contiguous, on one CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all inputs must be on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: inputs must be contiguous float32")
