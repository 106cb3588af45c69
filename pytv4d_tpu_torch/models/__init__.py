from . import ct, denoise
from .ct import (
    CPReconResult,
    clear_projector_cache,
    cp_reconstruct,
    estimate_op_norm,
    fbp,
    make_projector,
    radon,
    tgv_reconstruct,
)
from .denoise import TVDenoiser, add_noise, denoise_tv_chambolle
