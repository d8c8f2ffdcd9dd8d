from repro_torch.configs.base import (
    ARCH_IDS,
    PORTED_ARCHS,
    SHAPES,
    BlockDesc,
    ModelConfig,
    ShapeConfig,
    all_configs,
    get_config,
    supported_shapes,
)

__all__ = ["ARCH_IDS", "PORTED_ARCHS", "SHAPES", "BlockDesc", "ModelConfig",
           "ShapeConfig", "all_configs", "get_config", "supported_shapes"]
