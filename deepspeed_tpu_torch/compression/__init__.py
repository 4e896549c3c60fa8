from .quantization import (dequantize, dequantize_params,  # noqa: F401
                           quantize, quantize_params)
