from .convert import params_from_numpy, quantized_from_numpy
from .transformer import (CausalLM, TransformerConfig, alibi_slopes, apply_rope, cross_entropy_loss, gpt2_125m,
                          gpt2_1_3b, gpt2_tiny, init_params, llama2_7b, llama3_8b, llama_tiny, param_shapes,
                          rope_frequencies, scaled_rope_frequencies, transformer_forward)

__all__ = ["CausalLM", "TransformerConfig", "gpt2_tiny", "gpt2_125m", "gpt2_1_3b", "llama_tiny", "llama2_7b", "llama3_8b",
           "cross_entropy_loss", "transformer_forward", "init_params", "param_shapes", "params_from_numpy", "quantized_from_numpy", "rope_frequencies", "scaled_rope_frequencies",
           "apply_rope", "alibi_slopes"]
