from .quantization import QuantizedParam, dequantize_param, dequantize_tree, quantize_for_serving

__all__ = ["QuantizedParam", "dequantize_param", "dequantize_tree", "quantize_for_serving"]
