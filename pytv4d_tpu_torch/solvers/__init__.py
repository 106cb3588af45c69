from . import cp, fidelity, gd, progress, tgv
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
from .tgv import (
    TGV_FIELDS,
    TGV_NORM_BOUND_SQ,
    TGVResult,
    TGVState,
    tgv_denoise,
)
