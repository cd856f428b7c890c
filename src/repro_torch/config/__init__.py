"""Typed configuration of the port: CARAT's hyper-parameters, the
architectures of the LM stack and their registry, and the configs of a
training run."""
from repro_torch.config.types import (
    ArchConfig,
    AttentionKind,
    CaratConfig,
    CheckpointConfig,
    DataConfig,
    Family,
    MLAConfig,
    MoEConfig,
    ParallelConfig,
    RGLRUConfig,
    RunConfig,
    SHAPES,
    ShapeConfig,
    SSMConfig,
    TrainConfig,
    get_shape,
)
from repro_torch.config.arch_registry import (ARCHS, get_arch, list_archs,
                                              reduced_config, register_arch)

__all__ = [
    "ArchConfig",
    "AttentionKind",
    "CaratConfig",
    "CheckpointConfig",
    "DataConfig",
    "Family",
    "MLAConfig",
    "MoEConfig",
    "ParallelConfig",
    "RGLRUConfig",
    "RunConfig",
    "SHAPES",
    "ShapeConfig",
    "SSMConfig",
    "TrainConfig",
    "get_shape",
    "ARCHS",
    "get_arch",
    "list_archs",
    "reduced_config",
    "register_arch",
]
