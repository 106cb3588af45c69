from . import images, profiling
from .images import as_volume, cameraman, has_real_cameraman, synthetic_phantom
from .profiling import (
    cp_traffic_model,
    roofline_fraction,
    time_iterations,
)
