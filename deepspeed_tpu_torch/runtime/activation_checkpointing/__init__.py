from .checkpointing import (CheckpointFunction, checkpoint, configure, is_configured,
                            model_parallel_cuda_manual_seed, partitioned_checkpoint, reset)

__all__ = ["checkpoint", "configure", "is_configured", "reset", "CheckpointFunction",
           "partitioned_checkpoint", "model_parallel_cuda_manual_seed"]
