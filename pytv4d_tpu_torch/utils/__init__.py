from . import images, profiling
from .images import as_volume, cameraman, has_real_cameraman, synthetic_phantom
from .profiling import (
    cp_traffic_model,
    device_time,
    roofline_fraction,
    time_iterations,
    tv_traffic_model,
)
