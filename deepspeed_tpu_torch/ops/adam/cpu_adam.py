"""Host (CPU) optimizers over offloaded fp32 states.

Port of ``deepspeed_tpu/ops/adam/cpu_adam.py`` (reference
``deepspeed/ops/adam/cpu_adam.py``, ``DeepSpeedCPUAdam``, and the Adagrad
and Lion variants). The states are contiguous fp32 CPU tensors, stepped in
place by the host C++ (``csrc/host/cpu_adam.cpp``) through their
``data_ptr()`` on ``torch.get_num_threads()`` OpenMP threads. The
arithmetic is the JAX package's C++, so both packages step the same inputs
to the same bits; the ZeRO-Offload engine path (``runtime/zero/offload.py``)
owns the device<->host movement.

Each wrapper counts its calls (``cpu_adam_step.launches``, as the device
kernels count their launches). The ``*_ref`` functions are plain PyTorch
versions of the same steps, for the tests: they take the same operations
in the same order in fp32 and agree within rounding (the compiler may fuse
a multiply and an add).
"""

import ctypes
from typing import Optional

import torch

from ..native.builder import get_native_lib

_P, _I64, _F, _I, _D = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    "ds_adam_step": ([_P, _P, _P, _P, _I64, _F, _F, _F, _F, _F, _I64, _I, _I], None),
    "ds_adagrad_step": ([_P, _P, _P, _I64, _F, _F, _F, _I], None),
    "ds_lion_step": ([_P, _P, _P, _I64, _F, _F, _F, _F, _I], None),
    "ds_scale_sq_norm": ([_P, _I64, _F, _I], _D),
    "ds_scale": ([_P, _I64, _F, _I], None),
}


def _lib() -> ctypes.CDLL:
    lib = get_native_lib("ds_cpu_optim")
    if not getattr(lib, "_ds_sigs", False):
        for name, (args, res) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        lib._ds_sigs = True
    return lib


def _ptrs(*tensors: torch.Tensor):
    n = tensors[0].numel()
    for t in tensors:
        if t.device.type != "cpu" or t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != n:
            raise ValueError("the host optimizers step contiguous fp32 CPU tensors of one size, got "
                             f"{[(str(x.device), str(x.dtype), x.is_contiguous(), x.numel()) for x in tensors]}")
    return [t.data_ptr() for t in tensors], n


def _threads() -> int:
    return torch.get_num_threads()


def cpu_adam_step(p, g, m, v, lr: float, b1: float, b2: float, eps: float, weight_decay: float, step: int,
                  adamw_mode: bool = True) -> None:
    """One Adam(W) step of ``p`` in place, with ``m`` and ``v``; ``step`` is 1-based."""
    (pp, gp, mp, vp), n = _ptrs(p, g, m, v)
    _lib().ds_adam_step(pp, gp, mp, vp, n, lr, b1, b2, eps, weight_decay, int(step), int(bool(adamw_mode)),
                        _threads())
    cpu_adam_step.launches += 1


cpu_adam_step.launches = 0


def _f32(x) -> torch.Tensor:
    """A Python number as the C++'s ``float``: the plain versions round every constant as it does."""
    return torch.tensor(x, dtype=torch.float32)


def cpu_adam_ref(p, g, m, v, lr, b1, b2, eps, weight_decay, step, adamw_mode=True) -> None:
    one, b1, b2 = _f32(1.0), _f32(b1), _f32(b2)
    step_size = _f32(lr) / (one - b1 ** _f32(float(step)))
    bc2_sqrt = (one - b2 ** _f32(float(step))).sqrt()
    if not adamw_mode and weight_decay:
        g = g + _f32(weight_decay) * p
    m.copy_(b1 * m + (one - b1) * g)
    v.copy_(b2 * v + (one - b2) * g * g)
    update = step_size * (m / (v.sqrt() / bc2_sqrt + _f32(eps)))
    if adamw_mode and weight_decay:
        update = update + _f32(lr) * _f32(weight_decay) * p
    p.sub_(update)


def cpu_adagrad_step(p, g, sq_sum, lr: float, eps: float, weight_decay: float) -> None:
    (pp, gp, sp), n = _ptrs(p, g, sq_sum)
    _lib().ds_adagrad_step(pp, gp, sp, n, lr, eps, weight_decay, _threads())
    cpu_adagrad_step.launches += 1


cpu_adagrad_step.launches = 0


def cpu_adagrad_ref(p, g, sq_sum, lr, eps, weight_decay) -> None:
    if weight_decay:
        g = g + _f32(weight_decay) * p
    sq_sum.add_(g * g)
    p.sub_(_f32(lr) * g / (sq_sum.sqrt() + _f32(eps)))


def cpu_lion_step(p, g, m, lr: float, b1: float, b2: float, weight_decay: float) -> None:
    (pp, gp, mp), n = _ptrs(p, g, m)
    _lib().ds_lion_step(pp, gp, mp, n, lr, b1, b2, weight_decay, _threads())
    cpu_lion_step.launches += 1


cpu_lion_step.launches = 0


def cpu_lion_ref(p, g, m, lr, b1, b2, weight_decay) -> None:
    one, b1, b2 = _f32(1.0), _f32(b1), _f32(b2)
    update = torch.sign(b1 * m + (one - b1) * g)
    if weight_decay:
        update = update + _f32(weight_decay) * p
    p.sub_(_f32(lr) * update)
    m.copy_(b2 * m + (one - b2) * g)


def scale_sq_norm(g: torch.Tensor, scale: float = 1.0) -> float:
    """``g *= scale`` in place (fp32), then the sum of its squares in float64."""
    (gp,), n = _ptrs(g)
    out = _lib().ds_scale_sq_norm(gp, n, scale, _threads())
    scale_sq_norm.launches += 1
    return float(out)


scale_sq_norm.launches = 0


def scale_sq_norm_ref(g: torch.Tensor, scale: float = 1.0) -> float:
    if scale != 1.0:
        g.mul_(_f32(scale))
    return float((g * g).sum(dtype=torch.float64))


def scale_(g: torch.Tensor, scale: float) -> None:
    """``g *= scale`` in place (fp32)."""
    (gp,), n = _ptrs(g)
    _lib().ds_scale(gp, n, scale, _threads())
    scale_.launches += 1


scale_.launches = 0


class DeepSpeedCPUAdam:
    """Steps (params, exp_avg, exp_avg_sq) in place on the host."""

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0,
                 adamw_mode: bool = True):
        self.lr = lr
        self.betas = tuple(betas)
        self.eps = eps
        self.weight_decay = weight_decay
        self.adamw_mode = adamw_mode
        self.step_count = 0

    def step(self, params: torch.Tensor, grads: torch.Tensor, exp_avg: torch.Tensor, exp_avg_sq: torch.Tensor,
             lr: Optional[float] = None, step: Optional[int] = None) -> None:
        """One Adam step. ``step`` is the 1-based logical step shared by all
        parameters of one optimizer step; when None the handle's counter
        advances (single-tensor use)."""
        if step is None:
            self.step_count += 1
            step = self.step_count
        b1, b2 = self.betas
        cpu_adam_step(params, grads, exp_avg, exp_avg_sq, self.lr if lr is None else lr, b1, b2, self.eps,
                      self.weight_decay, step, self.adamw_mode)


class DeepSpeedCPUAdagrad:

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10, weight_decay: float = 0.0):
        self.lr, self.eps, self.weight_decay = lr, eps, weight_decay

    def step(self, params: torch.Tensor, grads: torch.Tensor, sq_sum: torch.Tensor,
             lr: Optional[float] = None) -> None:
        cpu_adagrad_step(params, grads, sq_sum, self.lr if lr is None else lr, self.eps, self.weight_decay)


class DeepSpeedCPULion:

    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.99), weight_decay: float = 0.0):
        self.lr, self.betas, self.weight_decay = lr, tuple(betas), weight_decay

    def step(self, params: torch.Tensor, grads: torch.Tensor, exp_avg: torch.Tensor,
             lr: Optional[float] = None) -> None:
        b1, b2 = self.betas
        cpu_lion_step(params, grads, exp_avg, self.lr if lr is None else lr, b1, b2, self.weight_decay)
