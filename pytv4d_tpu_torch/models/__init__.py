from . import denoise
from .denoise import TVDenoiser, add_noise, denoise_tv_chambolle
