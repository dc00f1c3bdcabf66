"""ZeRO optimizer offload: host (CPU) and NVMe optimizer states.

Port of ``deepspeed_tpu/runtime/zero/offload.py`` (reference ZeRO-Offload:
``runtime/zero/stage_1_and_2.py:1182-1277`` CPU offload,
``runtime/zero/stage3.py:1877,1925`` NVMe swap of the optimizer states
through ``swap_tensor/``, the CPU Adam of ``csrc/adam/cpu_adam_impl.cpp``).

The fp32 masters and the Adam moments of this rank's optimizer chunks live
in host RAM (``device="cpu"``) or, for the moments, in one file each under
a swap folder (``device="nvme"``, pipelined prefetch through the host AIO
pool); with ``params_on_nvme`` the masters are files too (``torch.from_file``
maps them, and the in-place host Adam writes through). Each step:

1. the engine's reduced gradients go device->host into pinned fp32
   buffers on a copy stream (plain buffers when the engine runs on the CPU);
2. on the host: the inverse loss scale, the global norm (a float64 sum of
   squares, summed over the ZeRO group by ``norm_reduce``), the overflow
   check (the step is skipped and nothing changes), the clip
   ``min(1, clip / (norm + 1e-6))``, then the C++ Adam over every leaf in
   place at one logical step;
3. the updated masters go host->device into the tensors the engine names,
   and nothing else returns.

The device then holds parameters and gradients, never optimizer state: the
offload memory contract. A master the engine keeps on the host (ZeRO-3
parameter offload) is shared, not copied: the host Adam steps the store
the engine gathers from. ``stats`` counts bytes and seconds of the three
phases (with a synchronise after each copy on a card).

Differences by design from the JAX class: it takes this rank's chunks (the
JAX one flattens the process's whole tree), a list of leaves rather than a
pytree, and the ``*_trees`` methods take and give lists in the engine's
leaf order.
"""

import logging
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ...ops.adam.cpu_adam import DeepSpeedCPUAdam, scale_, scale_sq_norm
from ..swap_tensor.optimizer_swapper import PartitionedOptimizerSwapper

logger = logging.getLogger(__name__)

_STATE_NAMES = ["exp_avg", "exp_avg_sq"]


def host_empty(shape, pin: bool) -> torch.Tensor:
    """An fp32 host tensor, pinned when it crosses to a card."""
    return torch.empty(shape, dtype=torch.float32, pin_memory=pin)


def file_tensor(path: str, shape) -> torch.Tensor:
    """An fp32 tensor whose storage is ``path`` mapped shared: writes go through to the file."""
    n = 1
    for s in shape:
        n *= int(s)
    with open(path, "wb") as f:
        f.truncate(n * 4)
    return torch.from_file(path, shared=True, size=n, dtype=torch.float32).view(shape)


class HostOffloadOptimizer:
    """Adam(W) over host-resident fp32 masters and moments (see the module note).

    ``masters`` are this rank's optimizer chunks, in the engine's leaf order;
    where ``shared[i]`` is set the tensor is a host tensor the engine also
    reads (it is adopted, not copied), else its values are copied into a
    host tensor of its own. With ``params_on_nvme`` every master is a file
    and the engine adopts ``master[i]`` of each shared leaf as its own."""

    def __init__(self, masters: Sequence[torch.Tensor], optimizer_params: Optional[Dict], device: torch.device,
                 offload_device: str = "cpu", nvme_path: Optional[str] = None, aio_threads: int = 4,
                 pipeline: bool = True, params_on_nvme: bool = False, params_nvme_path: Optional[str] = None,
                 shared: Optional[Sequence[bool]] = None, rank: int = 0):
        p = dict(optimizer_params or {})
        self._adam = DeepSpeedCPUAdam(lr=p.get("lr", 1e-3), betas=tuple(p.get("betas", (0.9, 0.999))),
                                      eps=p.get("eps", 1e-8), weight_decay=p.get("weight_decay", 0.01),
                                      adamw_mode=p.get("adam_w_mode", True))
        self.device = device
        self.pin = device.type == "cuda"
        self.offload_device = offload_device
        shared = list(shared) if shared is not None else [False] * len(masters)
        self.shared = shared
        self._master_folder: Optional[str] = None
        self.master: List[torch.Tensor] = []
        if params_on_nvme:
            # ZeRO-Infinity parameter NVMe offload (reference partitioned_param_swapper.py): the fp32 masters
            # are file-backed, host RAM holds only the page cache's working set
            self._master_folder = os.path.join(params_nvme_path or nvme_path or tempfile.mkdtemp(
                prefix="ds_tpu_param_nvme_"), f"rank{rank}")
            os.makedirs(self._master_folder, exist_ok=True)
            for i, m in enumerate(masters):
                if m.dim() == 0:
                    t = host_empty((), self.pin)
                else:
                    t = file_tensor(os.path.join(self._master_folder, f"master_{i}.bin"), tuple(m.shape))
                t.copy_(m.detach())
                self.master.append(t)
            logger.info(f"ZeRO-Infinity: fp32 master params on NVMe at {self._master_folder}")
        else:
            for m, sh in zip(masters, shared):
                if sh:
                    if m.device.type != "cpu" or m.dtype != torch.float32 or not m.is_contiguous():
                        raise ValueError("a shared master must be a contiguous fp32 host tensor")
                    self.master.append(m.detach())
                else:
                    t = host_empty(tuple(m.shape), self.pin)
                    t.copy_(m.detach())
                    self.master.append(t)
        self._names = [f"param_{i}" for i in range(len(self.master))]
        self._grads: Optional[List[torch.Tensor]] = None  # pinned fp32 gradient buffers, made on first step
        self._stream = torch.cuda.Stream(device) if device.type == "cuda" else None

        self._swapper: Optional[PartitionedOptimizerSwapper] = None
        self._moments: Optional[List[Dict[str, torch.Tensor]]] = None
        if offload_device == "nvme":
            folder = os.path.join(nvme_path or tempfile.mkdtemp(prefix="ds_tpu_nvme_"), f"rank{rank}")
            self.swap_folder = folder
            self._swapper = PartitionedOptimizerSwapper(folder, num_threads=aio_threads, pipeline=pipeline)
            for name, m in zip(self._names, self.master):
                self._swapper.initialize(name, {s: torch.zeros_like(m) for s in _STATE_NAMES})
            logger.info(f"ZeRO-Offload: optimizer states on NVMe at {folder}")
        else:
            self._moments = [{s: torch.zeros(m.shape, dtype=torch.float32) for s in _STATE_NAMES}
                             for m in self.master]
            logger.info(f"ZeRO-Offload: optimizer states in host RAM "
                        f"({sum(m.numel() for m in self.master) * 8 / 1e6:.1f} MB of moments)")
        self.stats = dict(steps=0, d2h_bytes=0, h2d_bytes=0, d2h_s=0.0, host_s=0.0, h2d_s=0.0)

    # ------------------------------------------------------------------ the step
    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _grads_to_host(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        if self._grads is None:
            self._grads = [host_empty(tuple(m.shape), self.pin) for m in self.master]
        t0 = time.perf_counter()
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                for b, g in zip(self._grads, grads):
                    b.copy_(g if g.dtype == torch.float32 else g.float(), non_blocking=True)
            self._sync()
        else:
            for b, g in zip(self._grads, grads):
                b.copy_(g)
        self.stats["d2h_s"] += time.perf_counter() - t0
        self.stats["d2h_bytes"] += sum(b.numel() * 4 for b in self._grads)
        return self._grads

    def _masters_to_device(self, out: Sequence[Optional[torch.Tensor]]) -> None:
        t0 = time.perf_counter()
        pairs = [(t, m) for t, m in zip(out, self.master) if t is not None]
        if self._stream is not None:
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._stream):
                for t, m in pairs:
                    t.copy_(m, non_blocking=True)
            torch.cuda.current_stream(self.device).wait_stream(self._stream)
            self._sync()
        else:
            for t, m in pairs:
                t.copy_(m)
        self.stats["h2d_s"] += time.perf_counter() - t0
        self.stats["h2d_bytes"] += sum(m.numel() * 4 for _, m in pairs)

    def step(self, grads: Sequence[torch.Tensor], lr: float, inv_scale: float = 1.0, grad_clip: float = 0.0,
             out: Optional[Sequence[Optional[torch.Tensor]]] = None, owned: Optional[Sequence[bool]] = None,
             norm_reduce: Optional[Callable[[float], float]] = None) -> Tuple[float, bool]:
        """Step every leaf; returns (global grad norm, overflow). ``out[i]``:
        the device tensor that receives leaf i's updated master (None: no
        copy); ``owned[i]``: whether leaf i's squares count on this rank;
        ``norm_reduce``: sums a rank's float over the ZeRO group. On
        overflow nothing is stepped or copied."""
        host = self._grads_to_host(grads)
        t0 = time.perf_counter()
        owned = [True] * len(host) if owned is None else owned
        sq = 0.0
        for g, own in zip(host, owned):
            s = scale_sq_norm(g, inv_scale)
            if own:
                sq += s
        if norm_reduce is not None:
            sq = norm_reduce(sq)
        gnorm = sq ** 0.5
        if not gnorm < float("inf"):  # inf or nan
            self.stats["host_s"] += time.perf_counter() - t0
            return gnorm, True
        if grad_clip > 0.0:
            coef = min(1.0, grad_clip / (gnorm + 1e-6))
            if coef < 1.0:
                for g in host:
                    scale_(g, coef)
        self._adam.step_count += 1
        step = self._adam.step_count  # one logical step shared by every leaf
        if self._swapper is None:
            for m, g, st in zip(self.master, host, self._moments):
                self._adam.step(m, g, st["exp_avg"], st["exp_avg_sq"], lr=lr, step=step)
        else:
            # pipelined: prefetch leaf i+1's states while leaf i steps (a plain blocking fetch a leaf otherwise)
            sw = self._swapper
            if sw.pipeline:
                sw.prefetch(self._names[0], _STATE_NAMES)
            for i, (m, g) in enumerate(zip(self.master, host)):
                st = sw.fetch(self._names[i], _STATE_NAMES)
                if sw.pipeline and i + 1 < len(self.master):
                    sw.prefetch(self._names[i + 1], _STATE_NAMES)
                self._adam.step(m, g, st["exp_avg"], st["exp_avg_sq"], lr=lr, step=step)
                sw.commit(self._names[i], st)
            sw.synchronize()
        self.stats["host_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        if out is not None:
            self._masters_to_device(out)
        return gnorm, False

    # ------------------------------------------------------------------ state
    def leaf_state(self, i: int) -> Dict[str, torch.Tensor]:
        """Leaf i's moments (read from disk under NVMe offload)."""
        if self._swapper is not None:
            return self._swapper.fetch(self._names[i], _STATE_NAMES)
        return self._moments[i]

    def set_leaf_state(self, i: int, st: Dict[str, torch.Tensor]) -> None:
        st = {k: torch.as_tensor(st[k]).to("cpu", torch.float32).contiguous().clone() if k in st
              else torch.zeros(self.master[i].shape, dtype=torch.float32) for k in _STATE_NAMES}
        if self._swapper is not None:
            self._swapper.commit(self._names[i], st, blocking=True)
        else:
            self._moments[i] = st

    def state_dict(self) -> Dict:
        # copies: an async checkpoint writer must not see later in-place steps
        return {"step": self._adam.step_count, "master": [m.clone() for m in self.master],
                "moments": [{k: v.clone() for k, v in self.leaf_state(i).items()} for i in range(len(self.master))]}

    def template_state_dict(self) -> Dict:
        """Structure only (no NVMe reads)."""
        return {"step": 0, "master": [torch.zeros_like(m) for m in self.master],
                "moments": [{s: torch.zeros_like(m) for s in _STATE_NAMES} for m in self.master]}

    def set_master(self, leaves: Sequence[torch.Tensor]) -> None:
        """Write new values into the host masters (shared ones are the engine's own: skipped)."""
        for i, (m, x) in enumerate(zip(self.master, leaves)):
            if not self.shared[i]:
                m.copy_(torch.as_tensor(x).detach().to("cpu", torch.float32))

    def load_state_dict(self, sd: Dict) -> None:
        self._adam.step_count = int(sd["step"])
        self.set_master(sd["master"])
        for i, st in enumerate(sd["moments"]):
            self.set_leaf_state(i, st)

    @property
    def step_count(self) -> int:
        return self._adam.step_count

    @step_count.setter
    def step_count(self, v: int) -> None:
        self._adam.step_count = int(v)

    def moments_trees(self) -> List[List[torch.Tensor]]:
        """One list per optimizer state (``exp_avg``, ``exp_avg_sq``), each leaf's tensor in engine order."""
        sts = [self.leaf_state(i) for i in range(len(self.master))]
        return [[st[s] for st in sts] for s in _STATE_NAMES]

    def set_moments_trees(self, trees: Sequence[Sequence[torch.Tensor]]) -> None:
        for i in range(len(self.master)):
            self.set_leaf_state(i, {s: tree[i] for s, tree in zip(_STATE_NAMES, trees)})

    @staticmethod
    def state_names() -> Tuple[str, ...]:
        return tuple(_STATE_NAMES)

    def host_bytes(self) -> Dict[str, int]:
        """Bytes this optimizer holds in host RAM: masters (file-backed ones not counted), moments, gradient buffers."""
        masters = 0 if self._master_folder is not None else sum(m.numel() * 4 for m in self.master)
        moments = 0 if self._moments is None else sum(v.numel() * 4 for st in self._moments for v in st.values())
        grads = 0 if self._grads is None else sum(g.numel() * 4 for g in self._grads)
        return dict(masters=masters, moments=moments, grad_buffers=grads)
