"""Port parity: fused AdamW (kernel D through its plain version) and the optimizers.

The same numpy state goes through three steps of the JAX
``fused_adam_flat(..., interpret=True)`` (the Pallas kernel in interpret
mode), of JAX ``adam_xla``, and of the port's ``fused_adam`` on CPU tensors
(its plain version), at a size that is not a multiple of the kernel block,
with and without weight decay; and a tree of ragged leaves in two param
groups goes through three ``FusedAdam`` steps (one ``fused_adam_multi`` a
group) and, leaf by leaf, through ``fused_adam_flat`` in interpret mode and
the JAX engine's ``_pallas_fused_adamw`` transform (on the CPU its registry
picks the XLA body). Tolerance: 1e-6 relative to the largest value of each
tensor (fp32; the port updates in place, the reference returns new buffers,
so the last ulp may differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.ops.pallas.fused_adam import adam_xla, fused_adam_flat
from deepspeed_tpu.runtime.optimizers import _pallas_fused_adamw
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


# two param groups of ragged leaves (sizes 1, 3, 4 and 5, past a 256 block, 2-D); "b" gets no gradient
GROUPS = [(0.0, {"a": (1,), "b": (3,), "c": (4097,), "d": (7, 9)}),
          (0.05, {"e": (4,), "f": (5,), "g": (33, 64)})]
NO_GRAD = "b"


def test_fused_adam_over_a_ragged_tree_in_two_groups_matches_jax():
    """Three ``FusedAdam`` steps (the second with a gradient multiplier of
    0.5) over two groups with different weight decay equal, leaf by leaf,
    JAX ``fused_adam_flat`` in interpret mode and ``_pallas_fused_adamw``
    over each group's tree; the leaf without a gradient does not move and
    gets no state, and CPU steps count no launch."""
    import optax

    rng = np.random.default_rng(3)
    init = {name: rng.standard_normal(shape).astype(np.float32) for _, leaves in GROUPS for name, shape in
            leaves.items()}
    tp = {name: torch.from_numpy(x.copy()) for name, x in init.items()}
    opt = FusedAdam([{"params": [tp[k] for k in leaves], "weight_decay": wd} for wd, leaves in GROUPS], lr=1e-2)
    flat = {k: (jnp.asarray(x), jnp.zeros(x.shape), jnp.zeros(x.shape)) for k, x in init.items() if k != NO_GRAD}
    txs = [_pallas_fused_adamw(1e-2, 0.9, 0.999, 1e-8, wd) for wd, _ in GROUPS]
    trees = [{k: jnp.asarray(init[k]) for k in leaves if k != NO_GRAD} for _, leaves in GROUPS]
    states = [tx.init(tree) for tx, tree in zip(txs, trees)]
    launches = fad.fused_adam.launches
    for step, mult in enumerate((1.0, 0.5, 1.0), start=1):
        grads = {k: rng.standard_normal(x.shape).astype(np.float32) for k, x in init.items() if k != NO_GRAD}
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k]) if k in grads else None
        opt.step(grad_mult=torch.tensor(mult))
        scaled = {k: jnp.asarray(g * np.float32(mult)) for k, g in grads.items()}
        for gi, (wd, leaves) in enumerate(GROUPS):
            for k in leaves:
                if k in flat:
                    flat[k] = fused_adam_flat(flat[k][0], scaled[k], flat[k][1], flat[k][2], lr=1e-2, step=step,
                                              weight_decay=wd, block=256, interpret=True)
            upd, states[gi] = txs[gi].update({k: scaled[k] for k in trees[gi]}, states[gi], trees[gi])
            trees[gi] = optax.apply_updates(trees[gi], upd)
    assert fad.fused_adam.launches == launches
    assert torch.equal(tp[NO_GRAD], torch.from_numpy(init[NO_GRAD])) and not opt.state[tp[NO_GRAD]]
    for gi, (_, leaves) in enumerate(GROUPS):
        for k in leaves:
            if k == NO_GRAD:
                continue
            state = opt.state[tp[k]]
            for got, want in ((tp[k], flat[k][0]), (state["exp_avg"], flat[k][1]), (state["exp_avg_sq"], flat[k][2])):
                _close(got.numpy(), want)
            _close(tp[k].numpy(), trees[gi][k])


def test_fused_adam_multi_ref_equals_fused_adam_ref_bit_for_bit():
    rng = np.random.default_rng(4)
    shapes = [(1,), (3,), (0,), (4,), (5,), (4097,), (3, 11)]
    state = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for _ in range(4)] for s in shapes]
    for leaf in state:
        leaf[3] = leaf[3].abs()
    scal = fad.adam_scalars(1e-3, 4, 0.9, 0.999, grad_mult=0.25)
    multi = [[t.clone() for t in leaf] for leaf in state]
    fad.fused_adam_multi(*[[leaf[i] for leaf in multi] for i in range(4)], scal, weight_decay=0.01)
    for p, g, m, v in state:
        fad.fused_adam_ref(p, g, m, v, scal, weight_decay=0.01)
    for got, want in zip(multi, state):
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_fused_adam_multi_takes_equal_lists():
    p = [torch.zeros(3)]
    scal = fad.adam_scalars(1e-3, 1, 0.9, 0.999)
    with pytest.raises(ValueError, match="1 params, 0 grads"):
        fad.fused_adam_multi(p, [], p, p, scal)
    fad.fused_adam_multi([], [], [], [], scal)  # nothing to update
