from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeConfig, get_config, list_archs, register,
)
