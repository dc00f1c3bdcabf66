from .quantization import (QuantizationContext, QuantizedParam, dequantize_param, dequantize_tree,
                           quantize_for_serving, quantize_model_params, quantize_param)

__all__ = ["QuantizedParam", "QuantizationContext", "quantize_model_params", "quantize_param", "dequantize_tree",
           "dequantize_param", "quantize_for_serving"]
