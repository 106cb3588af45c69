from . import cp, fidelity, progress
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
