from repro_torch.utils.registry import Registry
from repro_torch.utils.rng import RngStream

__all__ = ["Registry", "RngStream"]
