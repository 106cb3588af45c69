from . import device, images, profiling
from .device import on_device
from .images import as_volume, cameraman, has_real_cameraman, synthetic_phantom
from .profiling import (
    cp_traffic_model,
    device_time,
    roofline_fraction,
    tgv_traffic_model,
    time_iterations,
    tv_traffic_model,
)
