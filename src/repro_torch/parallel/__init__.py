"""Distribution layer of the port: sharding rules, activation
constraints and gradient compression (the twin of ``repro/parallel``)."""
from repro_torch.parallel.sharding import (
    P,
    param_rules,
    param_pspecs,
    batch_pspec,
    cache_pspec,
    make_shardings,
)
from repro_torch.parallel.compression import quantize_int8, dequantize_int8

__all__ = [
    "P", "param_rules", "param_pspecs", "batch_pspec", "cache_pspec",
    "make_shardings", "quantize_int8", "dequantize_int8",
]
