from . import admm as admm_mod
from . import cp, fidelity, fista as fista_mod, gd, inverse, progress, state, tgv
from .admm import ADMMResult, ADMMState, admm, admm_step, group_soft_threshold
from .cp import (
    CPPrecondState,
    CPResult,
    CPState,
    chambolle_pock,
    chambolle_pock_precond,
    cp_step,
    cp_step_precond,
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
from .fista import FISTAResult, fista
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
from .state import (
    load_state,
    load_state_orbax,
    load_state_torch,
    run_checkpointed,
    run_until_converged,
    save_state,
    save_state_orbax,
    save_state_torch,
)
