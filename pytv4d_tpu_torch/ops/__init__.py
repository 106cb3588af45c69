from . import api, operators, tv
from .operators import D, D_T, compute_L21_norm, tv_norm
from .tv import (
    make_tv,
    tv_and_subgrad,
    tv_central,
    tv_downwind,
    tv_hybrid,
    tv_upwind,
)
