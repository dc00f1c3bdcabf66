"""Learning-rate schedules.

A copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (plain Python): LRRangeTest,
OneCycle, WarmupLR, WarmupDecayLR, WarmupCosineLR with
``step()/get_lr()/get_last_lr()/initial_lr()/state_dict()/load_state_dict()``,
driven by the engine at each optimizer boundary (consume-then-step: an
optimizer step runs at the lr the previous scheduler step installed).
"""

import math
from typing import Dict, List, Optional

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR, WARMUP_COSINE_LR]


class _BaseSchedule:
    def __init__(self):
        self.last_batch_iteration = -1

    def get_lr(self) -> List[float]:
        raise NotImplementedError

    def initial_lr(self) -> Optional[float]:
        """The lr in force BEFORE the first ``step()`` — what the reference
        installs into the optimizer param groups at scheduler construction
        (None = leave the optimizer's own lr: Warmup* behavior; range-test
        and 1-cycle pre-install their start point)."""
        return None

    def get_last_lr(self) -> List[float]:
        return self._last_lr

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration
        self._last_lr = self.get_lr()
        return self._last_lr

    def state_dict(self) -> Dict:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict):
        self.last_batch_iteration = sd["last_batch_iteration"]
        if self.last_batch_iteration >= 0:
            self._last_lr = self.get_lr()
        else:
            # lbi < 0: the schedule never started — remove _last_lr (the
            # scheduler may have stepped before this load) so the engine's
            # first consumption stays at the pre-schedule lr, exactly like
            # a fresh scheduler (engine.get_lr() keys off hasattr)
            self.__dict__.pop("_last_lr", None)


class WarmupLR(_BaseSchedule):
    """Linear warmup from ``warmup_min_lr`` to ``warmup_max_lr`` then constant.

    Reference: ``runtime/lr_schedules.py`` ``WarmupLR``.
    """

    def __init__(self, optimizer=None, warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
                 warmup_num_steps: int = 1000, warmup_type: str = "log", last_batch_iteration: int = -1):
        super().__init__()
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration

    def _warmup_factor(self) -> float:
        # keyed on last_batch_iteration exactly as the reference's
        # _get_gamma (lr_schedules.py:705): the engine consumes the value a
        # step() call computed, so the clock must not be pre-advanced here
        if self.last_batch_iteration < 0:
            # fresh clock: the reference's get_lr guard (:679) — never
            # log(0) / negative-lr here (hit via load_state_dict of a
            # checkpoint taken before the first optimizer step)
            return 0.0
        if self.last_batch_iteration < self.warmup_num_steps:
            if self.warmup_type == "log":
                return self.inverse_log_warm_up * math.log(self.last_batch_iteration + 1)
            return self.last_batch_iteration / self.warmup_num_steps
        return 1.0

    def get_lr(self) -> List[float]:
        gamma = self._warmup_factor()
        return [self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * gamma]


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to 0 at ``total_num_steps``."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000, warmup_min_lr: float = 0.0,
                 warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000, warmup_type: str = "log",
                 last_batch_iteration: int = -1):
        super().__init__(optimizer, warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type, last_batch_iteration)
        self.total_num_steps = total_num_steps

    def _warmup_factor(self) -> float:
        # reference WarmupDecayLR._get_gamma (lr_schedules.py:762)
        if self.last_batch_iteration < self.warmup_num_steps:
            return super()._warmup_factor()
        return max(0.0, (self.total_num_steps - self.last_batch_iteration)
                   / max(1.0, self.total_num_steps - self.warmup_num_steps))


class WarmupCosineLR(_BaseSchedule):
    """Linear warmup (ratio) then cosine decay to ``cos_min_ratio``."""

    def __init__(self, optimizer=None, total_num_steps: int = 10000, warmup_min_ratio: float = 0.0,
                 warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001, warmup_type: str = "log",
                 last_batch_iteration: int = -1):
        super().__init__()
        self.total_num_steps = total_num_steps
        self.warmup_min_ratio = warmup_min_ratio
        self.warmup_num_steps = max(2, warmup_num_steps)
        self.cos_min_ratio = cos_min_ratio
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)
        self.last_batch_iteration = last_batch_iteration
        self.org_lrs = [0.001]

    def set_base_lr(self, lr: float):
        self.org_lrs = [lr]

    def get_lr_ratio(self) -> float:
        # reference WarmupCosineLR.get_lr_ratio (lr_schedules.py:822)
        lbi = self.last_batch_iteration
        if lbi < 0:
            return 0.0
        if lbi < self.warmup_num_steps:
            if self.warmup_type == "log":
                gamma = self.inverse_log_warm_up * math.log(lbi + 1)
            else:
                gamma = lbi / self.warmup_num_steps
            return self.warmup_min_ratio + (1.0 - self.warmup_min_ratio) * gamma
        real_last = lbi - self.warmup_num_steps + 1
        progress = min(1.0, real_last / max(1, self.total_num_steps - self.warmup_num_steps))
        cos = 0.5 * (1 + math.cos(math.pi * progress))
        return max(0.0, self.cos_min_ratio + (1 - self.cos_min_ratio) * cos)

    def get_lr(self) -> List[float]:
        return [lr * self.get_lr_ratio() for lr in self.org_lrs]


class LRRangeTest(_BaseSchedule):
    """LR range test: continuous/staircase ramp. Reference ``LRRangeTest``."""

    def __init__(self, optimizer=None, lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                 lr_range_test_step_rate: float = 1.0, lr_range_test_staircase: bool = False,
                 last_batch_iteration: int = -1):
        super().__init__()
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase
        self.last_batch_iteration = last_batch_iteration

    def initial_lr(self) -> Optional[float]:
        # reference pre-installs min_lr ONLY for a fresh schedule (:330
        # `if last_batch_iteration == -1`); a config-resumed clock keeps
        # the optimizer's construction lr for its first consumption
        return self.min_lr if self.last_batch_iteration == -1 else None

    def get_lr(self) -> List[float]:
        count = (self.last_batch_iteration + 1) / self.step_size
        if self.staircase:
            count = math.floor(count)
        return [self.min_lr * (1 + count * self.step_rate)]


class OneCycle(_BaseSchedule):
    """1-cycle policy over LR. Reference ``OneCycle`` (momentum cycling is a
    no-op here: the optimizer's betas are fixed at construction)."""

    def __init__(self, optimizer=None, cycle_min_lr: float = 1e-4, cycle_max_lr: float = 1e-3,
                 decay_lr_rate: float = 0.0, cycle_first_step_size: int = 2000, cycle_second_step_size: Optional[int] = None,
                 cycle_first_stair_count: int = 0, cycle_second_stair_count: Optional[int] = None,
                 decay_step_size: int = 0, cycle_momentum: bool = False, cycle_min_mom: float = 0.8,
                 cycle_max_mom: float = 0.9, decay_mom_rate: float = 0.0, last_batch_iteration: int = -1):
        super().__init__()
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.decay_lr_rate = decay_lr_rate
        self.first_size = float(cycle_first_step_size)
        self.second_size = float(cycle_second_step_size) if cycle_second_step_size is not None \
            else self.first_size
        self.total_size = self.first_size + self.second_size
        self.step_ratio = self.first_size / self.total_size
        self.decay_step_size = decay_step_size
        self.last_batch_iteration = last_batch_iteration

    def initial_lr(self) -> Optional[float]:
        # reference _initialize_lr (:494) — same fresh-clock-only gate
        return self.cycle_min_lr if self.last_batch_iteration == -1 else None

    def get_lr(self) -> List[float]:
        # reference OneCycle semantics exactly (lr_schedules.py:528,583):
        # triangular scale over (lbi+1) while lbi < total_size, then
        # post-cycle decay of min_lr by 1/(1 + rate * t/decay_step_size)
        if self.last_batch_iteration < self.total_size:
            bi = self.last_batch_iteration + 1
            cycle = math.floor(1 + bi / self.total_size)
            x = 1.0 + bi / self.total_size - cycle
            scale = x / self.step_ratio if x <= self.step_ratio \
                else (x - 1) / (self.step_ratio - 1)
            return [self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * scale]
        if self.decay_step_size == 0 or self.decay_lr_rate == 0:
            return [self.cycle_min_lr]
        decay_bi = self.last_batch_iteration - self.total_size + 1
        return [self.cycle_min_lr / (1 + self.decay_lr_rate * (decay_bi / self.decay_step_size))]


def get_lr_schedule_class(name: str):
    mapping = {
        LR_RANGE_TEST: LRRangeTest,
        ONE_CYCLE: OneCycle,
        WARMUP_LR: WarmupLR,
        WARMUP_DECAY_LR: WarmupDecayLR,
        WARMUP_COSINE_LR: WarmupCosineLR,
    }
    if name not in mapping:
        raise ValueError(f"Unknown scheduler {name}; valid: {VALID_LR_SCHEDULES}")
    return mapping[name]


def create_lr_scheduler(name: str, params: Dict):
    return get_lr_schedule_class(name)(optimizer=None, **params)
