"""mamba2-1.3b — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=2048, attention-free (d_ff=0: the Mamba2 block subsumes the
MLP), vocab=50280, ssm_state=128.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    vocab=50280,
    d_ff=0,
    ssm=SSMConfig(d_state=128, headdim=64, expand=2, conv_width=4, chunk=128),
    source="arXiv:2405.21060",
)
