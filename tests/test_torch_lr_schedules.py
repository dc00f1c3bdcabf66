"""Port parity: the LR schedules over 50 steps against the JAX schedules.

``WarmupDecayLR``, ``WarmupCosineLR``, ``LRRangeTest`` and ``OneCycle``
(``WarmupLR`` runs through the engine test) are built on both sides by
``create_lr_scheduler`` from the same config params, stepped 50 times, and
must give the same ``initial_lr`` and the same ``get_last_lr`` after every
step (both compute in Python floats: equal exactly). ``WarmupCosineLR``
scales the optimizer's base lr, given by ``set_base_lr`` as the engine does.
"""

import pytest

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.runtime.lr_schedules import create_lr_scheduler as jax_create
from deepspeed_tpu_torch.runtime.lr_schedules import create_lr_scheduler

SCHEDULES = [
    ("WarmupDecayLR", {"total_num_steps": 40, "warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupDecayLR", {"total_num_steps": 60, "warmup_max_lr": 2e-3, "warmup_num_steps": 7, "warmup_type": "linear"}),
    ("WarmupCosineLR", {"total_num_steps": 45, "warmup_min_ratio": 0.1, "warmup_num_steps": 8,
                        "cos_min_ratio": 0.01}),
    ("WarmupCosineLR", {"total_num_steps": 50, "warmup_num_steps": 5, "warmup_type": "linear"}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 6, "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_size": 6, "lr_range_test_step_rate": 0.5,
                     "lr_range_test_staircase": True}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 12, "decay_lr_rate": 0.1,
                  "decay_step_size": 5}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 10,
                  "cycle_second_step_size": 20, "cycle_first_stair_count": 3, "cycle_second_stair_count": 4}),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_fifty_steps_equal_the_jax_schedule(name, params):
    got, want = create_lr_scheduler(name, dict(params)), jax_create(name, dict(params))
    for sched in (got, want):
        if hasattr(sched, "set_base_lr"):
            sched.set_base_lr(3e-3)
    assert got.initial_lr() == want.initial_lr()
    seq_got, seq_want = [], []
    for _ in range(50):
        got.step()
        want.step()
        seq_got.append(got.get_last_lr()[0])
        seq_want.append(want.get_last_lr()[0])
    assert seq_got == seq_want
    assert len(set(seq_got)) > 3  # the schedule moved
