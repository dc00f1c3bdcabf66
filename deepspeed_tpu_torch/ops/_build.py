"""Build ``deepspeed_tpu_torch/csrc/*.cu`` with nvcc and load them with ctypes.

The sources have a plain C interface and include no PyTorch headers, so a
build takes seconds (``torch.utils.cpp_extension`` is not used). On first
use every ``.cu`` file is compiled to an object file by its own ``nvcc``
process, all started together, and the objects link into one shared
library under ``build/deepspeed_tpu_torch/`` at the repository root, named
by a hash of the sources and flags so a stale build is never loaded. A
failed build raises with the compiler's output; nothing falls back.
"""

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "deepspeed_tpu_torch")
# --split-compile=0: each nvcc runs its optimisation passes on as many threads as there are cores
# (flash_attention.cu holds the most kernel instantiations). Never add --use_fast_math or
# -prec-div=false: quantization.cu's codes and scales equal the plain version's only with IEEE division.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "--split-compile=0"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {"torch.float32": 0, "torch.bfloat16": 1}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry point -> argtypes (every pointer and the stream as c_void_p)
SIGNATURES: Dict[str, List] = {
    "ds_rms_norm": [_P, _P, _P, _LL, _I, _F, _I, _I, _P],
    "ds_layer_norm": [_P, _P, _P, _P, _LL, _I, _F, _I, _I, _P],
    "ds_quantized_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "ds_paged_attention_decode": [_P] * 10 + [_I] * 9 + [_F, _I, _P],
    "ds_paged_attention_prefill": [_P] * 11 + [_I] * 9 + [_F, _I, _P],
    "ds_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P],
    "ds_flash_bwd_dq": [_P] * 8 + [_I] * 4 + [_P, _P] + [_I] * 6 + [_F, _I, _I, _I, _P],
    "ds_flash_dq_collapsed_parts": [_I] * 7,
    "ds_flash_bwd_dq_collapsed": [_P] * 11 + [_I] * 6 + [_F] + [_I] * 7 + [_P],
    "ds_flash_bwd_dkv": [_P] * 8 + [_I] * 4 + [_P, _P] + [_I] * 6 + [_F, _I, _I, _I, _P],
    "ds_fused_adam": [_P, _P, _P, _P, _LL, _P, _F, _F, _F, _F, _F, _F, _P],
    "ds_lamb_direction": [_P, _P, _P, _P, _P, _LL, _P, _F, _F, _F, _F, _F, _F, _P],
    "ds_quantize_groupwise": [_P, _P, _P, _LL, _I, _I, _I, _P],
    "ds_dequantize_groupwise": [_P, _P, _P, _LL, _I, _I, _P],
    "ds_sparse_fwd": [_P] * 7 + [_I] * 9 + [_F, _I, _I, _P],
    "ds_sparse_bwd_dq": [_P] * 9 + [_I] * 9 + [_F, _I, _I, _P],
    "ds_sparse_bwd_dkv": [_P] * 11 + [_I] * 11 + [_F, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_log = ""        # compiler output of the last build (ptxas register/spill report)
build_seconds = 0.0   # wall time of the last build (0 when a finished build was loaded)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in /usr/local/cuda/bin): the CUDA kernels "
                           "of deepspeed_tpu_torch cannot be built")
    return path


def _sources() -> List[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile (if needed) and return the path of the shared library."""
    global build_log, build_seconds
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = _digest()
    lib_path = os.path.join(BUILD_DIR, f"libdstorch_{tag}.so")
    if os.path.exists(lib_path):
        build_seconds = 0.0
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        obj = os.path.join(BUILD_DIR, f"{os.path.splitext(os.path.basename(src))[0]}_{tag}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", src, "-o", obj]
        procs.append((obj, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                 text=True)))
    logs = []
    failed = []
    for obj, cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(obj)
    if failed:
        raise RuntimeError("nvcc failed to build the deepspeed_tpu_torch kernels:\n" + "\n".join(logs))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    link = [nvcc, "-shared", "-o", tmp] + [obj for obj, _, _ in procs]
    res = subprocess.run(link, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    logs.append(f"$ {' '.join(link)}\n{res.stdout}")
    if res.returncode != 0:
        raise RuntimeError("nvcc failed to link the deepspeed_tpu_torch kernels:\n" + "\n".join(logs))
    os.replace(tmp, lib_path)
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def dtype_code(dtype) -> int:
    try:
        return DTYPE_CODES[str(dtype)]
    except KeyError:
        raise NotImplementedError(f"the CUDA kernels take float32 and bfloat16, not {dtype}") from None


def check(rc: int, what: str) -> None:
    """Raise on a non-zero return of a C entry point (-2: configuration the
    kernel does not take; positive: a cudaError_t from the launch)."""
    if rc == -2:
        raise NotImplementedError(f"{what}: shape/dtype configuration not supported by the CUDA kernel")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {rc}")
