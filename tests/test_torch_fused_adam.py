"""Port parity: fused AdamW (kernel D through its plain version) and the optimizers.

The same numpy state goes through three steps of the JAX
``fused_adam_flat(..., interpret=True)`` (the Pallas kernel in interpret
mode), of JAX ``adam_xla``, and of the port's ``fused_adam`` on CPU tensors
(its plain version), at a size that is not a multiple of the kernel block,
with and without weight decay. Tolerance: 1e-6 relative to the largest
value of each tensor (fp32; the port updates in place, the reference
returns new buffers, so the last ulp may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.pallas.fused_adam import adam_xla, fused_adam_flat
from deepspeed_tpu_torch.ops import fused_adam as fad
from deepspeed_tpu_torch.runtime.optimizers import Adam, FusedAdam, create_optimizer

N = 1000  # not a multiple of the block (256 here, 1 << 16 by default)


def _close(got, want, tol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_fused_adam_three_steps_match_jax(wd):
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(N).astype(np.float32)
    grads = [rng.standard_normal(N).astype(np.float32) for _ in range(3)]
    jp = jx = jnp.asarray(p0)
    jm = jv = xm = xv = jnp.zeros(N, jnp.float32)
    tp, tm, tv = torch.from_numpy(p0.copy()), torch.zeros(N), torch.zeros(N)
    for step, g in enumerate(grads, start=1):
        jp, jm, jv = fused_adam_flat(jp, jnp.asarray(g), jm, jv, lr=1e-2, step=step, weight_decay=wd, block=256,
                                     interpret=True)
        jx, xm, xv = adam_xla(jx, jnp.asarray(g), xm, xv, 1e-2, step, weight_decay=wd)
        fad.fused_adam(tp, torch.from_numpy(g), tm, tv, fad.adam_scalars(1e-2, step, 0.9, 0.999), weight_decay=wd)
    for got, want, want_xla in ((tp, jp, jx), (tm, jm, xm), (tv, jv, xv)):
        _close(got.numpy(), want)
        _close(got.numpy(), want_xla)


def test_grad_multiplier_and_finite_flag():
    rng = np.random.default_rng(1)
    p, g = (torch.from_numpy(rng.standard_normal(N).astype(np.float32)) for _ in range(2))
    m, v = torch.zeros(N), torch.zeros(N)
    before = p.clone()
    fad.fused_adam(p, g, m, v, fad.adam_scalars(1e-2, 1, 0.9, 0.999, grad_mult=0.5, finite=False))
    assert torch.equal(p, before) and not m.any() and not v.any()
    fad.fused_adam(p, g, m, v, fad.adam_scalars(1e-2, 1, 0.9, 0.999, grad_mult=0.5))
    jp, jm, jv = adam_xla(jnp.asarray(before.numpy()), jnp.asarray(g.numpy() * 0.5), jnp.zeros(N), jnp.zeros(N),
                          1e-2, 1)
    _close(p.numpy(), jp)
    _close(m.numpy(), jm)


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_optimizer_steps_match_optax(adam_w_mode):
    """``create_optimizer`` (fusedadam) against the reference's optax transform:
    AdamW, or L2 Adam when ``adam_w_mode`` is false; a skipped step does not
    advance the step count."""
    import optax

    from deepspeed_tpu.runtime.optimizers import create_optimizer as jax_create

    params = {"lr": 1e-2, "weight_decay": 0.05, "adam_w_mode": adam_w_mode}
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((10, 7)).astype(np.float32)
    tx = jax_create("fusedadam", params)
    jp = jnp.asarray(p0)
    state = tx.init(jp)
    tp = torch.from_numpy(p0.copy())
    opt = create_optimizer("fusedadam", params, [tp])
    assert type(opt) is (FusedAdam if adam_w_mode else Adam)
    for step in range(3):
        g = rng.standard_normal((10, 7)).astype(np.float32)
        if step == 1:  # an overflowed step in between: nothing moves, the count stays
            tp.grad = torch.from_numpy(g)
            opt.step(finite=torch.tensor(False))
        upd, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        opt.step()
    _close(tp.numpy(), jp)
