"""Typed configuration of the port: CARAT's hyper-parameters, the
architectures of the LM stack and their registry."""
from repro_torch.config.types import (
    ArchConfig,
    AttentionKind,
    CaratConfig,
    Family,
    MLAConfig,
    MoEConfig,
    RGLRUConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    get_shape,
)
from repro_torch.config.arch_registry import (ARCHS, get_arch, list_archs,
                                              reduced_config, register_arch)

__all__ = [
    "ArchConfig",
    "AttentionKind",
    "CaratConfig",
    "Family",
    "MLAConfig",
    "MoEConfig",
    "RGLRUConfig",
    "SHAPES",
    "ShapeConfig",
    "SSMConfig",
    "get_shape",
    "ARCHS",
    "get_arch",
    "list_archs",
    "reduced_config",
    "register_arch",
]
