from . import checks, device, images, metrics, profiling, runlog
from .checks import assert_finite
from .device import on_device
from .images import as_volume, cameraman, has_real_cameraman, synthetic_phantom
from .metrics import mse, nrmse, psnr, ssim
from .profiling import (
    IterationTimer,
    cp_traffic_model,
    device_kind,
    device_time,
    force_read,
    roofline_fraction,
    tgv_traffic_model,
    time_iterations,
    trace,
    tv_traffic_model,
)
from .runlog import log_run
