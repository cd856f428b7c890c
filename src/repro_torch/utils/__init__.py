from repro_torch.utils.registry import Registry
from repro_torch.utils.logging import get_logger
from repro_torch.utils.rng import RngStream

__all__ = ["Registry", "get_logger", "RngStream"]
