#!/usr/bin/env python3
"""Unroll depth, block size, blocks an SM, cache hints and a TMA ring for fused Adam on one NVIDIA GPU.

    python3 adam_probe.py                   # from the repository root, on a machine with one CUDA GPU
    python3 adam_probe.py multi u2 tma      # only the variants named
    python3 adam_probe.py --parent DIR      # also DIR's fused_adam.cu, as variant "parent"

Builds ``csrc/fused_adam.cu`` as it stands (``multi``: one block a tile of 4,096 elements) and in variants
made by substituting text in it (``VARIANTS``: ``u1`` / ``u2`` / ``u8``, 1, 2 or 8 vectors of 16 bytes of each
array a thread in place of 4; ``bt128`` / ``bt512``, blocks of 128 or 512 threads; ``hints``, g loaded on the
read-only path without L1 allocation and p, m and v loaded and stored evict-first; ``l2_256``, loads that also
have L2 fetch the 256 bytes around them; ``persistent``, at most 4 blocks an SM split the tiles into equal
contiguous ranges, ``persistent_bps1`` at most 1, ``persistent_strided`` with tile i of a block at blockIdx + i x
gridDim; ``tma``, a persistent block an SM whose producer warp streams each tile's p, g, m and v into a ring of
``TMA_STAGES`` stages in shared memory with bulk copies (``cp.async.bulk``) while 256 consumer threads update
from there), each into its own library under ``build/adam_probe/``; names joined by ``+`` apply each one's
substitutions in turn (``u2+hints``). ``perleaf`` is ``multi``'s library called once per leaf, as the port
called its kernel before the multi-tensor launch; ``parent`` is DIR's kernel, once per leaf where DIR has only
the one-leaf entry point. Prints one JSON line each:
1. ``toolkit``: nvcc's version (the table of leaves is a kernel parameter of over 4 KB: CUDA 12.1 or later);
2. ``ptxas``: registers and spill-store bytes of each variant's kernel;
3. ``check``: each variant over ragged leaves (sizes 1 to 65,537, empty, views one element into their storage,
   a 2048 x 8192 weight) against the plain version (``max_rel_err`` against each tensor's largest value, at most
   1e-6) and bit for bit against ``multi``;
4. ``ceiling``: GB/s of a PyTorch copy, sum and add over 2 GiB tensors, for scale;
5. ``case``: over gpt2_1_3b's 388 leaves and over ``wte`` alone, each variant timed three times in turns (CUDA
   events, ``chip_smoke.py``'s ``time_ms``): medians, spreads and GB/s beside the bytes bound (28 bytes an
   element over 3.35 TB/s) and ``torch.optim.AdamW(fused=True)``.
The card's name and power limit come first.
"""

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(HERE, "deepspeed_tpu_torch", "csrc")
OUT = os.path.join(HERE, "build", "adam_probe")
SOURCE = "fused_adam.cu"
TMA_STAGES = 4
# The kernel's text is replaced from its note to the end of the anonymous namespace.
KERNEL_START = "// scal: [lr, bc1, bc2, grad_mult, finite]"
KERNEL_END = "}  // namespace\n}  // namespace dstorch\n"
TMA_KERNEL = """constexpr int kStages = %d;
constexpr size_t kRingBytes = static_cast<size_t>(kStages) * 4 * kTile * sizeof(float);

__device__ __forceinline__ uint32_t smem_u32(const void* a) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(a));
}
__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%%0], %%1;" ::"r"(smem_u32(b)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%%0], %%1;" ::"r"(smem_u32(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%%0];" ::"r"(smem_u32(b)) : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* b, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%%1], %%2; selp.u32 %%0, 1, 0, p; }"
                 : "=r"(done)
                 : "r"(smem_u32(b)), "r"(parity)
                 : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes, uint64_t* b) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%%0], [%%1], %%2, [%%3];"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(b))
               : "memory");
}

// scal: [lr, bc1, bc2, grad_mult, finite]. Warp kThreads / 32 produces: one lane copies each tile's p, g, m
// and v (its whole 16-byte vectors) into the next ring stage; the kThreads consumers update from the stage and
// store p, m and v to global memory, then free the stage.
__global__ void __launch_bounds__(kThreads + 32)
adam_kernel(const __grid_constant__ Table t, const float* __restrict__ scal, const Hyper hp) {
  extern __shared__ __align__(128) float ring[];  // [kStages][p, g, m, v][kTile]
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  if (scal[4] == 0.f) return;  // overflow: skip the step
  const Step s{scal[0], scal[1], scal[2], scal[3]};
  const long long tiles = t.tile0[t.leaves];
  const int begin = static_cast<int>(tiles * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(tiles * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kThreads / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int leaf = leaf_of(t, begin);
  if (threadIdx.x >= kThreads) {
    if (threadIdx.x == kThreads) {
      for (int tile = begin, i = 0; tile < end; ++tile, ++i) {
        while (tile >= t.tile0[leaf + 1]) ++leaf;
        const int st = i %% kStages;
        if (i >= kStages) bar_wait(&empty[st], (i / kStages - 1) & 1);
        const long long n = t.n[leaf], base = static_cast<long long>(tile - t.tile0[leaf]) * kTile;
        const uintptr_t bits = reinterpret_cast<uintptr_t>(t.p[leaf]) | reinterpret_cast<uintptr_t>(t.g[leaf]) |
                               reinterpret_cast<uintptr_t>(t.m[leaf]) | reinterpret_cast<uintptr_t>(t.v[leaf]);
        const long long len = n - base < kTile ? n - base : kTile;
        const uint32_t bytes = (bits & 15u) == 0 ? static_cast<uint32_t>(len / 4 * 16) : 0u;
        if (bytes == 0) {
          bar_arrive(&full[st]);
          continue;
        }
        bar_expect(&full[st], 4 * bytes);
        float* dst = ring + static_cast<size_t>(st) * 4 * kTile;
        bulk_load(dst, t.p[leaf] + base, bytes, &full[st]);
        bulk_load(dst + kTile, t.g[leaf] + base, bytes, &full[st]);
        bulk_load(dst + 2 * kTile, t.m[leaf] + base, bytes, &full[st]);
        bulk_load(dst + 3 * kTile, t.v[leaf] + base, bytes, &full[st]);
      }
    }
    return;
  }
  for (int tile = begin, i = 0; tile < end; ++tile, ++i) {
    while (tile >= t.tile0[leaf + 1]) ++leaf;
    const int st = i %% kStages;
    bar_wait(&full[st], (i / kStages) & 1);
    float* p = t.p[leaf];
    const float* g = t.g[leaf];
    float* m = t.m[leaf];
    float* v = t.v[leaf];
    const long long n = t.n[leaf];
    const long long base = static_cast<long long>(tile - t.tile0[leaf]) * kTile;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                           reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
    if ((bits & 15u) == 0) {
      const long long n4 = n / 4;
      const float* src = ring + static_cast<size_t>(st) * 4 * kTile;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = 4 * (u * kThreads + static_cast<int>(threadIdx.x));
        const long long e = base + k;
        if (e < 4 * n4) {
          float4 pp = *reinterpret_cast<const float4*>(src + k);
          const float4 gg = *reinterpret_cast<const float4*>(src + kTile + k);
          float4 mm = *reinterpret_cast<const float4*>(src + 2 * kTile + k);
          float4 vv = *reinterpret_cast<const float4*>(src + 3 * kTile + k);
          adam_four(pp, gg, mm, vv, s, hp);
          store4(p + e, pp);
          store4(m + e, mm);
          store4(v + e, vv);
        }
      }
      if (base + kTile > n && threadIdx.x < n - 4 * n4) adam_element(p, g, m, v, 4 * n4 + threadIdx.x, s, hp);
    } else {
      for (int u = 0; u < 4 * kUnroll; ++u) {
        const long long e = base + static_cast<long long>(u) * kThreads + threadIdx.x;
        if (e < n) adam_element(p, g, m, v, e, s, hp);
      }
    }
    __syncwarp();
    if (threadIdx.x %% 32 == 0) bar_arrive(&empty[st]);
  }
}

""" % TMA_STAGES
# A persistent grid: at most kBlocksPerSm blocks an SM (fewer where fewer fit) split the tiles into equal
# contiguous ranges, a block walking its range across leaf boundaries.
PERSISTENT_KERNEL = [("""  const int tile = blockIdx.x;
  adam_tile(t, leaf_of(t, tile), tile, s, hp);
""", """  const long long tiles = t.tile0[t.leaves];
  const int begin = static_cast<int>(tiles * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(tiles * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  int leaf = leaf_of(t, begin);
  for (int tile = begin; tile < end; ++tile) {
    while (tile >= t.tile0[leaf + 1]) ++leaf;
    adam_tile(t, leaf, tile, s, hp);
  }
""")]
PERSISTENT_LAUNCH = [(
    "  adam_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(",
    """  constexpr int kBlocksPerSm = 4;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  static const int resident = [] {
    int r = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, adam_kernel, kThreads, 0) == cudaSuccess && r > 0 ? r
                                                                                                              : 1;
  }();
  const long long most = static_cast<long long>(sms) * (resident < kBlocksPerSm ? resident : kBlocksPerSm);
  adam_kernel<<<static_cast<unsigned>(tiles < most ? tiles : most), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(""")]
PERSISTENT = PERSISTENT_KERNEL + PERSISTENT_LAUNCH
# tile i of a persistent block is blockIdx + i x gridDim
STRIDED = [("""  const int begin = static_cast<int>(tiles * blockIdx.x / gridDim.x);
  const int end = static_cast<int>(tiles * (blockIdx.x + 1) / gridDim.x);
  if (begin >= end) return;
  int leaf = leaf_of(t, begin);
  for (int tile = begin; tile < end; ++tile) {
""", """  int leaf = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
""")]
# TMA_KERNEL in place of the kernel, on a persistent grid of one block an SM (its ring takes 128 KB)
TMA = PERSISTENT_LAUNCH + [
    ("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;"),  # a stage of 2,048 elements an array
    ("cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, adam_kernel, kThreads, 0)",
     "cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, adam_kernel, kThreads + 32, kRingBytes)"),
    ("  adam_kernel<<<static_cast<unsigned>(tiles < most ? tiles : most), kThreads, 0,\n",
     "  static const cudaError_t smem_ok = allow_smem(adam_kernel, kRingBytes);\n"
     "  if (smem_ok != cudaSuccess) return static_cast<int>(smem_ok);\n"
     "  adam_kernel<<<static_cast<unsigned>(tiles < most ? tiles : most), kThreads + 32, kRingBytes,\n"),
]
LOADS = """__device__ __forceinline__ float4 load4(const float* a) { return *reinterpret_cast<const float4*>(a); }
__device__ __forceinline__ void store4(float* a, float4 x) { *reinterpret_cast<float4*>(a) = x; }
"""
# g on the read-only path without L1 allocation, p, m and v loaded and stored evict-first
HINTS = [(LOADS, """__device__ __forceinline__ float4 load_nc(const float* a) {
  float4 r;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(a));
  return r;
}
__device__ __forceinline__ float4 load4(const float* a) { return __ldcs(reinterpret_cast<const float4*>(a)); }
__device__ __forceinline__ void store4(float* a, float4 x) { __stcs(reinterpret_cast<float4*>(a), x); }
"""), ("      gg[u] = load4(g + e);", "      gg[u] = load_nc(g + e);")]
# loads that also have L2 fetch the 256 bytes around them
L2_256 = [(LOADS, """__device__ __forceinline__ float4 load4(const float* a) {
  float4 r;
  asm("ld.global.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];" : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w) : "l"(a));
  return r;
}
__device__ __forceinline__ void store4(float* a, float4 x) { *reinterpret_cast<float4*>(a) = x; }
""")]
# variant name -> substitutions (old, new) in fused_adam.cu ("tma" also replaces the kernel: TMA_KERNEL)
VARIANTS = {
    "multi": [],
    "u1": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;")],
    "u2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "u8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
    "bt128": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "bt512": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "hints": HINTS,
    "l2_256": L2_256,
    "persistent": PERSISTENT,
    "persistent_bps1": PERSISTENT + [("constexpr int kBlocksPerSm = 4;", "constexpr int kBlocksPerSm = 1;")],
    "persistent_strided": PERSISTENT + STRIDED,
    "tma": TMA,
}
CALLED = {"perleaf": "multi"}  # variants that call another variant's library in another way
# ds_fused_adam(p, g, m, v, n, scal, b1, 1 - b1, b2, 1 - b2, eps, wd, stream): the one-leaf entry point of builds
# before the multi-tensor launch
OLD_SIGNATURE = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_float] * 6 + [ctypes.c_void_p]
HBM_BYTES_PER_S = 3.35e12


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def known(name):
    """A variant, a called variant, or variants joined by "+" (their substitutions one after the other)."""
    return name in CALLED or all(part in VARIANTS for part in name.split("+"))


def variant_source(name):
    with open(os.path.join(CSRC, SOURCE)) as f:
        text = f.read()
    for part in name.split("+"):
        if part == "tma":
            i, j = text.index(KERNEL_START), text.index(KERNEL_END)
            text = text[:i] + TMA_KERNEL + text[j:]
        for old, new in VARIANTS[part]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not once in {SOURCE}")
            text = text.replace(old, new)
    return text


def build(names, parent):
    """One library per variant from its own copy of the source. Returns {name: (path, ptxas log)}."""
    from deepspeed_tpu_torch.ops import _build

    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        vdir = os.path.join(OUT, name)
        shutil.rmtree(vdir, ignore_errors=True)
        os.makedirs(vdir)
        src = os.path.join(vdir, SOURCE)
        if name == "parent":
            shutil.copy(os.path.join(parent, "deepspeed_tpu_torch", "csrc", SOURCE), src)
            inc = os.path.join(parent, "deepspeed_tpu_torch", "csrc")
        else:
            with open(src, "w") as f:
                f.write(variant_source(name))
            inc = CSRC
        lib = os.path.join(OUT, f"lib_{name}.so")
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", inc, "-shared", src, "-o", lib]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        libs[name] = (lib, out)
    return libs


def ptxas_entries(text):
    """(registers, spill-store bytes) of the Adam kernel in a ptxas -v log."""
    rows, entry, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "adam" in entry:
            rows.append(dict(registers=int(m.group(1)), spill_store_bytes=spill))
            entry = None
    return rows


def load(path):
    """A stand-in for ``_build.lib()`` exposing ``ds_fused_adam_multi`` (the one-leaf entry point of an older
    build, once per leaf, through ``chip_smoke.OldAdamEntry``)."""
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build

    handle = ctypes.CDLL(path)
    multi = hasattr(handle, "ds_fused_adam_multi")
    fn = handle.ds_fused_adam_multi if multi else handle.ds_fused_adam
    fn.argtypes = _build.SIGNATURES["ds_fused_adam_multi"] if multi else OLD_SIGNATURE
    fn.restype = ctypes.c_int
    return types.SimpleNamespace(ds_fused_adam_multi=fn if multi else cs.OldAdamEntry(fn))


def leaves_of(torch, dev, shapes, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for shape, offset in shapes:
        n = math.prod(shape)
        leaf = [torch.randn(n + offset, generator=g, device=dev)[offset:].view(shape) for _ in range(4)]
        leaf[2].mul_(1e-3)
        leaf[3].abs_().mul_(1e-6)
        out.append(leaf)
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("adam_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from deepspeed_tpu_torch.ops import _build, fused_adam as fad

    parent = argv[argv.index("--parent") + 1] if "--parent" in argv else None
    names = [n for n in argv if known(n)] or list(VARIANTS) + list(CALLED)
    if parent is not None:
        names.append("parent")
    built = sorted({CALLED.get(n, n) for n in names} | {"multi"})
    log(cs.card_line())
    res = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True)
    log(dict(phase="toolkit", nvcc=res.stdout.strip().splitlines()[-1] if res.stdout else res.stderr.strip()))
    libs = build(built, parent and os.path.abspath(parent))
    for name in built:
        log(dict(phase="ptxas", variant=name, entries=ptxas_entries(libs[name][1])))
    handles = {name: load(libs[CALLED.get(name, name)][0]) for name in names + ["multi"]}
    dev = torch.device("cuda", 0)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    scal = fad.adam_scalars(1e-4, 10, 0.9, 0.999, grad_mult=0.7, device=dev)
    saved = _build._lib

    def call(name, leaves):
        lists = [[leaf[i] for leaf in leaves] for i in range(4)]
        _build._lib = handles[name]
        try:
            if name in ("perleaf", "parent"):
                for leaf in leaves:
                    fad.fused_adam(*leaf, scal, **hyper)
            else:
                fad.fused_adam_multi(*lists, scal, **hyper)
        finally:
            _build._lib = saved

    # correctness: ragged, empty and unaligned leaves and one large weight, from the same state for each variant
    check = [((1,), 0), ((3,), 0), ((4,), 0), ((5,), 0), ((4097,), 0), ((0,), 0), ((65537,), 0), ((4097,), 1),
             ((6,), 1), ((2048, 8192), 0)]
    want = leaves_of(torch, dev, check, 11)
    fad.fused_adam_multi_ref(*[[leaf[i] for leaf in want] for i in range(4)], scal, **hyper)
    outs = {}
    for name in ["multi"] + [n for n in names if n != "multi"]:
        got = leaves_of(torch, dev, check, 11)
        call(name, got)
        torch.cuda.synchronize()
        outs[name] = got
        rel = max(((a[i] - b[i]).abs().max() / b[i].abs().max()).item() for a, b in zip(got, want)
                  for i in (0, 2, 3) if b[i].numel())
        equal = all(torch.equal(a[i], b[i]) for a, b in zip(got, outs["multi"]) for i in (0, 2, 3))
        log(dict(phase="check", variant=name, max_rel_err=rel, ok=rel <= 1e-6, bit_equal_to_multi=equal))
    del outs, want
    torch.cuda.empty_cache()

    # the card's streaming rates through PyTorch calls, for scale: a copy (read and write), a sum (read) and an
    # add (two reads, a write) over 2 GiB tensors
    a = torch.randn(1 << 29, device=dev)
    b, c = torch.empty_like(a), torch.empty_like(a)
    nb = a.numel() * a.element_size()
    rates = {"copy": (lambda: b.copy_(a), 2 * nb), "sum": (lambda: a.sum(), nb),
             "add": (lambda: torch.add(a, b, out=c), 3 * nb)}
    log(dict(phase="ceiling", gb_per_s={k: moved / cs.time_ms(fn, 20) / 1e6 for k, (fn, moved) in rates.items()}))
    del a, b, c
    torch.cuda.empty_cache()

    shapes = cs.gpt2_leaf_shapes()
    for case in ("all", "wte"):
        leaves = leaves_of(torch, dev, [(s, 0) for p, s in shapes if case == "all" or p == "wte"], 7)
        n = sum(leaf[0].numel() for leaf in leaves)
        runs = {name: [] for name in names}
        for turn in range(3):
            for name in names[turn % len(names):] + names[:turn % len(names)]:
                runs[name].append(cs.time_ms(lambda: call(name, leaves), 20))
        for leaf in leaves:
            leaf[0].grad = leaf[1]
        opt = torch.optim.AdamW([leaf[0] for leaf in leaves], lr=1e-4, weight_decay=0.01, fused=True)
        lib_ms = cs.time_ms(opt.step, 20)
        del opt
        nbytes = 28 * n
        med = {name: sorted(ts)[1] for name, ts in runs.items()}
        log(dict(phase="case", case=case, leaves=len(leaves), elements=n, ms=med,
                 spread={name: max(ts) - min(ts) for name, ts in runs.items()},
                 gb_per_s={name: nbytes / ms / 1e6 for name, ms in med.items()}, library_ms=lib_ms,
                 bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, best=min(med, key=med.get)))
        del leaves
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
