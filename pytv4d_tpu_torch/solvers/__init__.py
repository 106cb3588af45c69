from . import cp, fidelity, gd, inverse, progress, tgv
from .cp import (
    CPResult,
    CPState,
    chambolle_pock,
    cp_step,
    default_tau,
    dual_prox,
    init_state,
    pd_gap,
)
from .fidelity import (
    fidelity_conjugate,
    fidelity_dual_prox,
    fidelity_loss,
    validate_fidelity,
)
from .gd import GDResult, gd_step, subgradient_descent
from .inverse import (
    InverseResult,
    InverseState,
    cp_inverse,
    exact_transpose,
    gaussian_blur_operator,
    pd_gap_inverse,
    power_iteration,
    reg_discrepancy,
)
from .tgv import (
    TGV_FIELDS,
    TGV_NORM_BOUND_SQ,
    TGVInverseState,
    TGVResult,
    TGVState,
    tgv_denoise,
    tgv_gap_inverse,
    tgv_inverse,
)
