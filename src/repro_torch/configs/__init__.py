"""Configuration data of the port: the CARAT spaces
(:mod:`repro_torch.configs.carat_defaults`) and one module per
architecture of the LM stack. Importing this package registers the
architectures."""
from repro_torch.configs import (  # noqa: F401
    granite_3_2b,
    command_r_plus_104b,
    h2o_danube_1_8b,
    internlm2_20b,
    mamba2_370m,
    recurrentgemma_2b,
    paligemma_3b,
    moonshot_v1_16b_a3b,
    deepseek_v3_671b,
    hubert_xlarge,
)
