from . import operators
from .operators import D, D_T, compute_L21_norm, tv_norm
