from repro_torch.configs.base import (
    PORTED_ARCHS,
    BlockDesc,
    ModelConfig,
    get_config,
)

__all__ = ["PORTED_ARCHS", "BlockDesc", "ModelConfig", "get_config"]
