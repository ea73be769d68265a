from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, SHAPES, arch_names, cells, get_config, reduced)
