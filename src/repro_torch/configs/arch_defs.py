"""Imports every per-arch config module, populating the registry."""
from repro_torch.configs import (  # noqa: F401
    yi_34b,
    codeqwen1_5_7b,
    qwen1_5_0_5b,
    tinyllama_1_1b,
    internvl2_26b,
    mamba2_780m,
    musicgen_large,
    llama4_scout_17b_a16e,
    llama4_maverick_400b_a17b,
    zamba2_1_2b,
)
