from .base import ArchConfig, EncoderConfig, MoEConfig, SSMConfig
from .registry import ARCHS, SHAPES, InputShape, get_arch, get_shape

__all__ = [
    "ArchConfig", "EncoderConfig", "MoEConfig", "SSMConfig",
    "ARCHS", "SHAPES", "InputShape", "get_arch", "get_shape",
]
