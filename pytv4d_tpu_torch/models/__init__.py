from . import ct, denoise
from .ct import (
    ConeBeamGeometry,
    CPReconResult,
    FanBeamGeometry,
    SARTResult,
    clear_projector_cache,
    cp_reconstruct,
    estimate_op_norm,
    fbp,
    fdk,
    make_cone_projector,
    make_fan_projector,
    make_projector,
    radon,
    radon_cone,
    radon_fan,
    sart,
    tgv_reconstruct,
)
from .denoise import TVDenoiser, add_noise, denoise_tv_chambolle
