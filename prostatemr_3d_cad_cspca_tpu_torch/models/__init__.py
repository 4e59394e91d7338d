"""The M1 model family: blocks, M1Core, M1Net, M1CascadedNet, M1."""

from .blocks import (  # noqa: F401
    ConfigurableDropout,
    GridAttentionBlock3D,
    SEResNetBottleNeck,
    leaky_relu01,
)
from .m1_core import M1Core  # noqa: F401
from .m1_net import M1CascadedNet, M1Net, decision_fusion  # noqa: F401
from .m1 import M1, m1  # noqa: F401
