"""Utilities: timing/benchmark harness, failure handling, metrics,
device peaks and the compilation cache."""

from custereomatching_tpu.utils.failsafe import (
    device_healthcheck,
    is_transient_device_error,
    with_retries,
)
from custereomatching_tpu.utils.metrics import (
    bad_pixel_rate,
    disparity_metrics,
    end_point_error,
)
from custereomatching_tpu.utils.profiling import (
    device_specs,
    trace,
    zncc_roofline,
)
from custereomatching_tpu.utils.timer import Timer, TimerError, benchmark

__all__ = [
    "Timer",
    "TimerError",
    "bad_pixel_rate",
    "benchmark",
    "device_healthcheck",
    "device_specs",
    "disparity_metrics",
    "end_point_error",
    "is_transient_device_error",
    "trace",
    "with_retries",
    "zncc_roofline",
]
