#!/usr/bin/env python3
"""Team width, rows a block and a persistent grid for the norms' row body on one NVIDIA GPU.

    python3 norm_probe.py                       # from the repository root, on a machine with one CUDA GPU
    python3 norm_probe.py rows lv16 persistent  # only the variants named
    python3 norm_probe.py --parent DIR          # also DIR's rms_norm.cu and layer_norm.cu, as variant "parent"

Builds ``csrc/rms_norm.cu`` and ``csrc/layer_norm.cu`` with ``csrc/norm_rows.cuh`` as it stands
(``rows``) and in variants made by substituting text in the header (``VARIANTS``: ``lv1`` to ``lv16``, 1 to
16 vectors of 16 bytes a lane in place of 4, so teams of more or fewer lanes; ``bt128`` / ``bt512``, blocks of
at most 128 or 512 threads; ``persistent`` (``PERSISTENT``), a grid of the SMs times the resident blocks,
each team loading its next row while it reduces the current one; ``nopin``, without the fence that keeps
ptxas from sinking the parameters' loads), each into its own library under ``build/norm_probe/``.
Prints one JSON line each:
1. ``ptxas``: registers and spill-store bytes of every norm kernel of each variant;
2. ``case``: RMSNorm and LayerNorm at d 128 (the qk-norm: T x 32 heads of 128 rows), 2048 and 4096, at
   T 8, 768 and 2048, x in bf16 and fp32, w (and b) in bf16 and fp32: each variant's cold device time
   (``chip_smoke.py``'s ``time_ms_rotating``: a CUDA graph over copies of x of over 100 MB, the same copies
   for every variant and for the library's call), whether it is within ``chip_smoke.py``'s ``TOL`` of the
   plain version and repeats bit for bit, beside the bytes bound and ``F.rms_norm`` / ``F.layer_norm``
   (null for LayerNorm with parameters of another type than x's, which ``F.layer_norm`` refuses).
The card's name and power limit come first.
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "deepspeed_tpu_torch", "csrc")
OUT = os.path.join(HERE, "build", "norm_probe")
SOURCES = ("rms_norm.cu", "layer_norm.cu")
HEADER = "norm_rows.cuh"
# The persistent grid: the SMs times the resident blocks, each team walking rows and loading its next row's x
# while it reduces and stores the current one, w and b held across rows.
PERSISTENT = [
    ("  const int row = blockIdx.x * teams + team;", "  int row = blockIdx.x * teams + team;"),
    ("""  int slot = 0;
  norm_row<LN, T, W, LANES, NV>(xv, wv, bv, out + static_cast<size_t>(row) * d, lane, nvec, d, eps, mask,
                                red[LANES > 32 ? team : 0], slot, team);
""", """  int slot = 0;
  const int stride = gridDim.x * teams;
  for (;;) {
    const bool more = row < rows - stride;
    Pack<16> xn[NV];
    if (more) {
      const T* xq = x + static_cast<size_t>(row + stride) * d;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        if (lane + k * LANES < nvec) xn[k] = load_pack<16>(xq + (lane + k * LANES) * VEC);
      }
    }
    norm_row<LN, T, W, LANES, NV>(xv, wv, bv, out + static_cast<size_t>(row) * d, lane, nvec, d, eps, mask,
                                  red[LANES > 32 ? team : 0], slot, team);
    if (!more) break;
    row += stride;
#pragma unroll
    for (int k = 0; k < NV; ++k) xv[k] = xn[k];
  }
"""),
    ("""  const unsigned blocks = static_cast<unsigned>((rows + teams - 1) / teams);
  if constexpr (LN) {
    layer_norm_rows_kernel<T, W, LANES, NV><<<blocks, teams * LANES, 0, stream>>>(x, w, b, out, rows, d, eps);
  } else {
    rms_norm_rows_kernel<T, W, LANES, NV><<<blocks, teams * LANES, 0, stream>>>(x, w, b, out, rows, d, eps);
  }
""", """  unsigned blocks = static_cast<unsigned>((rows + teams - 1) / teams);
  const auto kernel = [] {
    if constexpr (LN) {
      return layer_norm_rows_kernel<T, W, LANES, NV>;
    } else {
      return rms_norm_rows_kernel<T, W, LANES, NV>;
    }
  }();
  int resident = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, teams * LANES, 0) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const unsigned most = static_cast<unsigned>(resident > 0 ? resident : 1) * sms;
  blocks = blocks < most ? blocks : most;
  kernel<<<blocks, teams * LANES, 0, stream>>>(x, w, b, out, rows, d, eps);
"""),
]
# variant name -> substitutions (old, new) in norm_rows.cuh
VARIANTS = {
    "rows": [],
    "lv1": [("kLaneVectors = 4;", "kLaneVectors = 1;")],
    "lv2": [("kLaneVectors = 4;", "kLaneVectors = 2;")],
    "lv8": [("kLaneVectors = 4;", "kLaneVectors = 8;")],
    "lv16": [("kLaneVectors = 4;", "kLaneVectors = 16;")],
    "bt128": [("kBlockThreads = 256;", "kBlockThreads = 128;")],
    "bt512": [("kBlockThreads = 256;", "kBlockThreads = 512;")],
    "persistent": PERSISTENT,
    "nopin": [("  __threadfence_block();\n", "")],
}
WIDTHS = (128, 2048, 4096)
TOKENS = (8, 768, 2048)
QK_HEADS = 32  # rows of a token at d 128: the qk-norm over llama3_8b's 32 query heads


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def build(names, parent):
    """One library per variant from its own copy of the sources. Returns {name: (path, ptxas log)}."""
    from deepspeed_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        vdir = os.path.join(OUT, name)
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        src_dir = os.path.join(parent, "deepspeed_tpu_torch", "csrc") if name == "parent" else CSRC
        files = SOURCES if name == "parent" else SOURCES + (HEADER,)
        for file in files:
            shutil.copy(os.path.join(src_dir, file), vdir)
        if name != "parent":
            path = os.path.join(vdir, HEADER)
            text = open(path).read()
            for old, new in VARIANTS[name]:
                if text.count(old) != 1:
                    raise RuntimeError(f"variant {name}: {old!r} is not once in {HEADER}")
                text = text.replace(old, new)
            with open(path, "w") as f:
                f.write(text)
        for file in SOURCES:  # a header beside the source is found before the -I directory's
            obj = os.path.join(vdir, file.replace(".cu", ".o"))
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", src_dir, "-c", os.path.join(vdir, file), "-o", obj]
            procs[(name, file)] = (obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                         text=True))
    logs = {}
    for (name, file), (obj, proc) in procs.items():
        logs[name] = logs.get(name, "") + proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} {file}:\n{logs[name]}")
    libs = {}
    for name in names:
        lib = os.path.join(OUT, f"lib_{name}.so")
        objs = [procs[(name, file)][0] for file in SOURCES]
        res = subprocess.run([nvcc, "-shared", "-o", lib] + objs, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"link failed for {name}:\n{res.stdout}")
        libs[name] = (lib, logs[name])
    return libs


def demangle(names):
    try:
        res = subprocess.run(["c++filt"], input="\n".join(names), capture_output=True, text=True, timeout=30)
        out = res.stdout.splitlines()
        return out if res.returncode == 0 and len(out) == len(names) else names
    except OSError:
        return names


def ptxas_entries(text):
    """(kernel, registers, spill-store bytes) of each norm kernel in a ptxas -v log."""
    rows, entry, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "norm" in entry:
            rows.append((entry, int(m.group(1)), spill))
            entry = None
    names = demangle([r[0] for r in rows])
    return [dict(kernel=re.sub(r"dstorch::\(anonymous namespace\)::", "", n).replace("__nv_bfloat16", "bf16"),
                 registers=r, spill_store_bytes=s) for n, (_, r, s) in zip(names, rows)]


def load(path):
    from deepspeed_tpu_torch.ops import _build

    handle = ctypes.CDLL(path)
    for name in ("ds_rms_norm", "ds_layer_norm"):
        fn = getattr(handle, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("norm_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build, norms

    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    names = [n for n in argv if n in VARIANTS] or list(VARIANTS)
    if parent is not None:
        names.append("parent")
    log(cs.card_line())
    libs = build(names, parent and os.path.abspath(parent))
    for name in names:
        log(dict(phase="ptxas", variant=name, entries=ptxas_entries(libs[name][1])))
    handles = {name: load(libs[name][0]) for name in names}
    dev = torch.device("cuda", 0)
    dtypes = (torch.bfloat16, torch.float32)
    F = torch.nn.functional
    saved = _build._lib
    for ln in (False, True):
        for d in WIDTHS:
            for T in TOKENS:
                rows = T * QK_HEADS if d == 128 else T
                for xdt in dtypes:
                    for wdt in dtypes:
                        g = torch.Generator(device=dev).manual_seed(d + T)
                        x = (torch.randn((rows, d), generator=g, device=dev) * 2.0 + (0.5 if ln else 0.0)).to(xdt)
                        w = torch.randn((d,), generator=g, device=dev).to(wdt)
                        b = torch.randn((d,), generator=g, device=dev).to(wdt)
                        if ln:
                            run = lambda xx: norms.layer_norm(xx, w, b, 1e-5)
                            lib = lambda xx: F.layer_norm(xx, (d,), w, b, 1e-5)
                            want = norms.layer_norm_ref(x, w, b, 1e-5)
                        else:
                            run = lambda xx: norms.rms_norm(xx, w, 1e-5)
                            lib = lambda xx: F.rms_norm(xx, (d,), w, 1e-5)
                            want = norms.rms_norm_ref(x, w, 1e-5)
                        what, tol = cs.TOL[str(xdt)]
                        nbytes = 2 * x.numel() * x.element_size() + (2 if ln else 1) * d * w.element_size()
                        copies = [(x.clone(),) for _ in range(max(2, 100_000_000 // (x.numel() * x.element_size())
                                                               + 1))]
                        ms, ok = {}, {}
                        for name in names:
                            _build._lib = handles[name]
                            try:
                                got, again = run(x), run(x)
                                torch.cuda.synchronize()
                                ms[name] = cs.time_ms_rotating(run, copies, 50)
                            finally:
                                _build._lib = saved
                            ok[name] = cs.errors(got, want)[what] <= tol and torch.equal(got, again)
                        try:
                            lib_ms = cs.time_ms_rotating(lib, copies, 50)
                        except RuntimeError:  # F.layer_norm takes no parameters of another type than x's
                            lib_ms = None
                        bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
                        log(dict(phase="case", norm="layer_norm" if ln else "rms_norm", d=d, T=T, rows=rows,
                                 x=str(xdt)[6:], w=str(wdt)[6:], ms=ms, library_ms=lib_ms, bound_ms=bound_ms,
                                 best=min(ms, key=ms.get), ok=ok))
                        del copies, x, want
                        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
