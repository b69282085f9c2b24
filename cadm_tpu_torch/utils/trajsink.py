"""ctypes binding of the native async trajectory sink (counterpart of
cadm_tpu/utils/trajsink.py), the same API and file format.

The trainer hands each iteration's newly collected transitions to a C++
writer thread (``native/trajsink.cpp``), so the loop never waits on the
filesystem; when the writer's queue is over budget a record is dropped and
counted, never blocked on. The library is compiled with ``g++`` at first use
into ``cadm_tpu_torch/_build/`` (named by a hash of the source, so an edited
source rebuilds); without a compiler ``TrajectorySink.available()`` is False.

File format: a 16-byte magic, then records ``[u64 tag][u64 nbytes][bytes]``;
each array is a META record (JSON name, dtype, shape) followed by its ARRAY
record, the two admitted or dropped together.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import os
import struct as pystruct
import subprocess
import tempfile
from typing import Iterator, Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
_SRC_PATH = os.path.join(_ROOT, "native", "trajsink.cpp")
_BUILD_DIR = os.path.join(_ROOT, "cadm_tpu_torch", "_build")

_MAGIC = b"CADMTRAJSINK v1\x00"
TAG_ARRAY = 1
TAG_META = 2


def _build() -> Optional[str]:
    """Path of the compiled library, building it if needed; None if the
    source or the compiler is missing or the build fails."""
    try:
        with open(_SRC_PATH, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:12]
    except OSError:
        return None
    so = os.path.join(_BUILD_DIR, f"libtrajsink-{digest}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                        _SRC_PATH, "-o", tmp, "-lpthread"],
                       check=True, capture_output=True)
        os.replace(tmp, so)  # concurrent builds each rename a whole file
    except (OSError, subprocess.CalledProcessError):
        return None
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    u64, vp, cp = ctypes.c_uint64, ctypes.c_void_p, ctypes.c_char_p
    lib.trajsink_open.restype = vp
    lib.trajsink_open.argtypes = [cp, u64]
    lib.trajsink_append2.restype = ctypes.c_int
    lib.trajsink_append2.argtypes = [vp, u64, cp, u64, u64, cp, u64]
    lib.trajsink_flush.restype = None
    lib.trajsink_flush.argtypes = [vp]
    lib.trajsink_dropped.restype = u64
    lib.trajsink_dropped.argtypes = [vp]
    lib.trajsink_written.restype = u64
    lib.trajsink_written.argtypes = [vp]
    lib.trajsink_close.restype = None
    lib.trajsink_close.argtypes = [vp]
    _lib = lib
    return lib


class TrajectorySink:
    """Async binary writer of named numpy arrays (or CPU tensors)."""

    @staticmethod
    def available() -> bool:
        return _load() is not None

    def __init__(self, path: str, max_queue_mb: int = 512):
        lib = _load()
        if lib is None:
            raise RuntimeError("native trajsink unavailable (no g++?)")
        self._lib = lib
        self._h = lib.trajsink_open(path.encode(), max_queue_mb * 1024 * 1024)
        if not self._h:
            raise OSError(f"could not open {path}")

    def append(self, name: str, array) -> bool:
        """Queue ``array`` under ``name``; False if it was dropped."""
        arr = np.ascontiguousarray(array)
        meta = json.dumps({"name": name, "dtype": str(arr.dtype),
                           "shape": arr.shape}).encode()
        return bool(self._lib.trajsink_append2(
            self._h, TAG_META, meta, len(meta),
            TAG_ARRAY, arr.tobytes(), arr.nbytes))

    def flush(self) -> None:
        """Return once every queued record is in the file."""
        self._lib.trajsink_flush(self._h)

    @property
    def dropped(self) -> int:
        return int(self._lib.trajsink_dropped(self._h))

    @property
    def written(self) -> int:
        return int(self._lib.trajsink_written(self._h))

    def close(self) -> None:
        if self._h:
            self._lib.trajsink_close(self._h)
            self._h = None


def read_trajfile(path: str) -> Iterator[Tuple[str, np.ndarray]]:
    """Stream (name, array) pairs back from a sink file."""
    with open(path, "rb") as f:
        if f.read(16) != _MAGIC:
            raise ValueError(f"{path}: not a trajectory sink file")
        pending_meta = None
        while True:
            head = f.read(16)
            if len(head) < 16:
                return
            tag, n = pystruct.unpack("<QQ", head)
            payload = f.read(n)
            if tag == TAG_META:
                pending_meta = json.loads(payload)
            elif tag == TAG_ARRAY and pending_meta is not None:
                arr = np.frombuffer(
                    payload, dtype=np.dtype(pending_meta["dtype"])
                ).reshape(pending_meta["shape"])
                yield pending_meta["name"], arr
                pending_meta = None
