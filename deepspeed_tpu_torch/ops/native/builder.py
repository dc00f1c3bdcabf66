"""Build the port's host C++ (``csrc/host/*.cpp``) with g++ and load it with ctypes.

Port of ``deepspeed_tpu/ops/native/builder.py`` (reference
``op_builder/builder.py``, ``OpBuilder.load``). The host code of ZeRO-Offload
(the CPU optimizers, the async file I/O) has a plain C interface and
includes no PyTorch header. Each library is compiled on first use with
``g++ -O3 -std=c++17 -shared -fPIC -fopenmp -march=native`` into
``build/deepspeed_tpu_torch/`` at the repository root (the CUDA kernels'
build folder), named by a hash of its sources, its flags and the host CPU
(``-march=native`` code built on one CPU may not run on another) so a
stale build is never loaded, linked to a private temporary name and
renamed into place so another process never loads half a file. A failed build raises with the
compiler's output: there is no fallback to plainer flags or to Python.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

from .._build import BUILD_DIR, CSRC_DIR

HOST_DIR = os.path.join(CSRC_DIR, "host")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp", "-march=native"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _cpu_tag() -> str:
    """The host CPU as ``-march=native`` sees it: the machine and the first core's model and flags."""
    found = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":")[0].strip()
                if key in ("model name", "flags") and key not in found:
                    found[key] = line.strip()
    except OSError:
        pass
    return "\n".join([platform.machine(), *found.values()])


class NativeOpBuilder:
    """One shared library built from ``sources`` (file names under ``source_dir``)."""

    def __init__(self, name: str, sources: List[str], source_dir: str = HOST_DIR, build_dir: str = BUILD_DIR,
                 flags: Optional[List[str]] = None):
        self.name = name
        self.sources = [os.path.join(source_dir, s) for s in sources]
        self.build_dir = build_dir
        self.flags = list(CXX_FLAGS if flags is None else flags)

    def _hash(self) -> str:
        h = hashlib.sha256(" ".join(self.flags).encode())
        h.update(_cpu_tag().encode())
        for s in self.sources:
            h.update(os.path.basename(s).encode())
            with open(s, "rb") as f:
                h.update(f.read())
        return h.hexdigest()[:16]

    def so_path(self) -> str:
        return os.path.join(self.build_dir, f"{self.name}-{self._hash()}.so")

    def build(self) -> str:
        """Compile (if needed) and return the library's path; raises ``RuntimeError`` on failure."""
        missing = [s for s in self.sources if not os.path.isfile(s)]
        if missing:
            raise RuntimeError(f"host library {self.name}: missing sources {missing}")
        out = self.so_path()
        if os.path.exists(out):
            return out
        cxx = shutil.which("g++")
        if cxx is None:
            raise RuntimeError(f"host library {self.name}: g++ is not on PATH, so the host C++ of "
                               "deepspeed_tpu_torch (ZeRO-Offload) cannot be built")
        os.makedirs(self.build_dir, exist_ok=True)
        tmp = f"{out}.tmp-{os.getpid()}"
        cmd = [cxx, *self.flags, "-o", tmp, *self.sources]
        try:
            res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"g++ failed to build host library {self.name}:\n$ {' '.join(cmd)}\n"
                                   f"{res.stdout[-4000:]}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return out

    def load(self) -> ctypes.CDLL:
        with _lock:
            if self.name not in _loaded:
                _loaded[self.name] = ctypes.CDLL(self.build())
            return _loaded[self.name]


BUILDERS = {
    "ds_cpu_optim": NativeOpBuilder("ds_cpu_optim", ["cpu_adam.cpp"]),
    "ds_aio": NativeOpBuilder("ds_aio", ["aio.cpp"]),
}


def get_native_lib(name: str) -> ctypes.CDLL:
    """The loaded host library ``name`` (``ds_cpu_optim`` or ``ds_aio``), built on first use."""
    return BUILDERS[name].load()


def native_available(name: str) -> bool:
    """Whether ``name`` builds and loads here (a probe: ``get_native_lib`` raises instead)."""
    try:
        get_native_lib(name)
        return True
    except (RuntimeError, OSError):
        return False
