from . import ct, ct_spectral, denoise
from .ct import (
    ConeBeamGeometry,
    CPReconResult,
    FanBeamGeometry,
    SARTResult,
    clear_projector_cache,
    cone_sinogram_sharding,
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
    sinogram_sharding,
    tgv_reconstruct,
)
from .ct_spectral import (
    cone_spectral_precond_sums,
    fdk_spectral,
    make_cone_spectral_projector,
    make_fan_spectral_projector,
    make_spectral_projector,
    radon_cone_spectral,
    radon_fan_spectral,
    radon_spectral,
)
from .denoise import TVDenoiser, add_noise, denoise_tv_chambolle
