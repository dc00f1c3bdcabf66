"""Generic async tensor <-> NVMe swapping.

Port of ``deepspeed_tpu/runtime/swap_tensor/async_swapper.py`` (reference
``runtime/swap_tensor/async_swapper.py``). Each named tensor is one file,
``<swap_folder>/<name with / as -->.swp``, holding its raw bytes; reads
and writes ride the host AIO thread pool (``ops/aio``), so swapping
overlaps with host compute. The file names and contents are the JAX
swapper's.
"""

import os
from typing import Dict, Optional, Tuple

import torch

from ...ops.aio import AsyncIOHandle


class AsyncTensorSwapper:

    def __init__(self, swap_folder: str, num_threads: int = 4):
        self.swap_folder = swap_folder
        os.makedirs(swap_folder, exist_ok=True)
        self._handle = AsyncIOHandle(num_threads=num_threads)
        self._shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}

    def _path(self, name: str) -> str:
        return os.path.join(self.swap_folder, name.replace("/", "--") + ".swp")

    def swap_out(self, name: str, t: torch.Tensor) -> None:
        """Start writing ``t`` to disk (async: call ``synchronize``)."""
        t = t.contiguous()
        self._shapes[name] = (tuple(t.shape), t.dtype)
        self._handle.async_pwrite(t, self._path(name))

    def swap_in(self, name: str, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Start reading ``name`` into ``out`` (allocated if None); its
        contents are valid only after ``synchronize()``."""
        shape, dtype = self._shapes[name]
        if out is None:
            out = torch.empty(shape, dtype=dtype)
        self._handle.async_pread(out, self._path(name))
        return out

    def contains(self, name: str) -> bool:
        return name in self._shapes

    def synchronize(self) -> None:
        errors = self._handle.wait()
        if errors:
            raise IOError(f"{errors} tensor swap operations failed under {self.swap_folder}")

    def release(self, name: str) -> None:
        self._shapes.pop(name, None)
        try:
            os.remove(self._path(name))
        except OSError:
            pass

    def close(self) -> None:
        self._handle.close()
