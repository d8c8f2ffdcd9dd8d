from repro_torch.configs.base import (
    PORTED_ARCHS,
    SHAPES,
    BlockDesc,
    ModelConfig,
    ShapeConfig,
    get_config,
)

__all__ = ["PORTED_ARCHS", "SHAPES", "BlockDesc", "ModelConfig",
           "ShapeConfig", "get_config"]
