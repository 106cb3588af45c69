from . import config, schemes
from .config import TVConfig
from .schemes import (
    AXIS_COL,
    AXIS_ROW,
    AXIS_T,
    AXIS_Z,
    BWD,
    CTR,
    FWD,
    SCHEMES,
    Channel,
    channel_weight,
    num_channels,
    operator_norm_bound_sq,
    scheme_channels,
)
