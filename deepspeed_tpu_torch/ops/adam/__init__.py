from .cpu_adam import DeepSpeedCPUAdagrad, DeepSpeedCPUAdam, DeepSpeedCPULion

__all__ = ["DeepSpeedCPUAdam", "DeepSpeedCPUAdagrad", "DeepSpeedCPULion"]
