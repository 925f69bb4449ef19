"""Weight-only and KV-cache quantization (mirrors `repro.quant`)."""
from repro_torch.quant.qtypes import (DEFAULT_GROUP, QUANT_KEYS, QTensor,
                                      asdense, dequantize, dequantize_kv,
                                      pack_int4, quantize, quantize_int4,
                                      quantize_int8, quantize_kv,
                                      quantize_params, tree_nbytes,
                                      unpack_int4)

__all__ = ["DEFAULT_GROUP", "QUANT_KEYS", "QTensor", "asdense", "dequantize",
           "dequantize_kv", "pack_int4", "quantize", "quantize_int4",
           "quantize_int8", "quantize_kv", "quantize_params", "tree_nbytes",
           "unpack_int4"]
