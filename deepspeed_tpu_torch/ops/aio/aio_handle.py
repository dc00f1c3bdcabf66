"""Async tensor file I/O handle.

Port of ``deepspeed_tpu/ops/aio/aio_handle.py`` (reference
``csrc/aio/py_lib/deepspeed_py_aio_handle.cpp``: ``async_pread`` /
``async_pwrite`` / ``wait`` over a thread pool). Backed by the host C++
thread pool of ``csrc/host/aio.cpp``; a failed build raises. Buffers are
contiguous CPU tensors (the engine pins the ones that also cross to the
card); a file holds a buffer's raw bytes at the given offset, as the JAX
handle writes them, so either package reads the other's files.
"""

import ctypes
from typing import List

import torch

from ..native.builder import get_native_lib, native_available


def aio_available() -> bool:
    """Whether the host I/O library builds and loads here."""
    return native_available("ds_aio")


def _lib() -> ctypes.CDLL:
    lib = get_native_lib("ds_aio")
    if not getattr(lib, "_ds_sigs", False):
        lib.ds_aio_handle_create.restype = ctypes.c_void_p
        lib.ds_aio_handle_create.argtypes = [ctypes.c_int]
        lib.ds_aio_handle_destroy.argtypes = [ctypes.c_void_p]
        for name in ("ds_aio_pwrite", "ds_aio_pread"):
            getattr(lib, name).argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
                                           ctypes.c_int64]
        lib.ds_aio_wait.restype = ctypes.c_int64
        lib.ds_aio_wait.argtypes = [ctypes.c_void_p]
        lib._ds_sigs = True
    return lib


def _buffer(t: torch.Tensor) -> torch.Tensor:
    if t.device.type != "cpu" or not t.is_contiguous():
        raise ValueError(f"async file I/O takes contiguous CPU tensors, got one on {t.device} "
                         f"(contiguous: {t.is_contiguous()})")
    return t


class AsyncIOHandle:
    """Submit overlapped reads and writes of CPU tensors; ``wait()`` to sync.

    A tensor given to an async operation must stay alive and unmodified
    until ``wait()`` returns: the handle keeps a reference to each."""

    def __init__(self, num_threads: int = 4):
        self._lib = _lib()
        self._h = self._lib.ds_aio_handle_create(int(num_threads))
        self._inflight: List[torch.Tensor] = []
        self.bytes_written = 0
        self.bytes_read = 0

    def async_pwrite(self, t: torch.Tensor, path: str, offset: int = 0) -> None:
        t = _buffer(t)
        nbytes = t.numel() * t.element_size()
        self._inflight.append(t)
        self._lib.ds_aio_pwrite(self._h, t.data_ptr(), nbytes, path.encode(), int(offset))
        self.bytes_written += nbytes

    def async_pread(self, t: torch.Tensor, path: str, offset: int = 0) -> None:
        t = _buffer(t)
        nbytes = t.numel() * t.element_size()
        self._inflight.append(t)
        self._lib.ds_aio_pread(self._h, t.data_ptr(), nbytes, path.encode(), int(offset))
        self.bytes_read += nbytes

    def wait(self) -> int:
        """Block until every submitted operation ends; returns the number that failed."""
        errors = int(self._lib.ds_aio_wait(self._h))
        self._inflight.clear()
        return errors

    def close(self) -> None:
        if self._h is not None:
            self.wait()
            self._lib.ds_aio_handle_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
