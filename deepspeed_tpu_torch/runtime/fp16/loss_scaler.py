"""Loss scaling for fp16 training.

Port of ``deepspeed_tpu/runtime/fp16/loss_scaler.py`` (reference
``LossScaler`` static, ``DynamicLossScaler``). Overflow is detected on the
device by the engine; the scaler is host-side Python updated once per
optimizer boundary, and only the dynamic scaler needs the overflow bit on
the host.
"""

import logging

import torch

logger = logging.getLogger(__name__)


class LossScalerBase:
    def __init__(self, scale: float):
        self.cur_scale = float(scale)
        self.dynamic = False

    @property
    def loss_scale(self) -> float:
        return self.cur_scale

    def update_scale(self, overflow: bool):
        pass


class LossScaler(LossScalerBase):
    """Static loss scale."""

    def __init__(self, scale: float = 1.0):
        super().__init__(scale)

    def update_scale(self, overflow: bool):
        if overflow:
            logger.warning("Overflow with static loss scale — step skipped; consider dynamic scaling")


class DynamicLossScaler(LossScalerBase):
    """Halve on overflow (with hysteresis), double every ``scale_window``
    clean steps. Reference ``loss_scaler.py:91``."""

    def __init__(self, init_scale: float = 2**32, scale_factor: float = 2.0, scale_window: int = 1000,
                 min_scale: float = 1.0, delayed_shift: int = 1, consecutive_hysteresis: bool = False,
                 raise_error_at_min_scale: bool = True):
        super().__init__(init_scale)
        self.dynamic = True
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_scale = min_scale
        self.delayed_shift = delayed_shift
        self.cur_hysteresis = delayed_shift
        self.consecutive_hysteresis = consecutive_hysteresis
        self.raise_error_at_min_scale = raise_error_at_min_scale
        self.last_overflow_iter = -1
        self.cur_iter = 0

    def update_scale(self, overflow: bool):
        if overflow:
            if self.delayed_shift == 1 or self.cur_hysteresis == 1:
                if self.cur_scale == self.min_scale and self.raise_error_at_min_scale:
                    raise Exception("Current loss scale already at minimum — cannot decrease further")
                self.cur_scale = max(self.cur_scale / self.scale_factor, self.min_scale)
                logger.info(f"Overflow: reducing loss scale to {self.cur_scale}")
            else:
                self.cur_hysteresis -= 1
            self.last_overflow_iter = self.cur_iter
        else:
            if self.consecutive_hysteresis:
                self.cur_hysteresis = self.delayed_shift
            if (self.cur_iter - self.last_overflow_iter) % self.scale_window == 0 and self.cur_iter > self.last_overflow_iter:
                if not self.consecutive_hysteresis:
                    self.cur_hysteresis = self.delayed_shift
                self.cur_scale *= self.scale_factor
        self.cur_iter += 1


def create_loss_scaler(fp16_config, dtype: torch.dtype) -> LossScalerBase:
    """Pick the scaler from the fp16 config section (reference ``CreateLossScaler``):
    a static scale of 1 unless the compute dtype is float16 and fp16 is enabled."""
    if dtype != torch.float16 or not fp16_config.enabled:
        return LossScaler(1.0)
    if fp16_config.dynamic_loss_scale:
        return DynamicLossScaler(
            init_scale=2**fp16_config.initial_scale_power,
            scale_window=fp16_config.loss_scale_window,
            min_scale=fp16_config.min_loss_scale,
            delayed_shift=fp16_config.hysteresis,
            consecutive_hysteresis=fp16_config.consecutive_hysteresis,
        )
    return LossScaler(fp16_config.loss_scale)
