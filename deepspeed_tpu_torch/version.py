"""Version info for deepspeed_tpu_torch (tracks the JAX package it ports)."""

__version__ = "0.1.0"

# Capability parity target of the reference package: DeepSpeed 0.14.3.
reference_version = "0.14.3"
