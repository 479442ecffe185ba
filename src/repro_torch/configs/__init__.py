from repro_torch.configs.base import (  # noqa: F401
    ALL_SHAPES,
    SHAPES_BY_NAME,
    ArchConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    all_archs,
    get_arch,
    reduced,
    shapes_for,
)
