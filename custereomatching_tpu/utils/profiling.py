"""Profiling: device trace capture and roofline accounting.

The reference's entire observability story is unsynchronized wall-clock
prints (survey §5.1, custma/utils.py).  Here: (a) a context manager
around ``jax.profiler`` for real device traces viewable in Perfetto /
TensorBoard, and (b) roofline accounting for the ZNCC pipeline against
the published peaks of the device, so a benchmark can report its
distance from the hardware bound.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional

import jax

# Published peaks by ``device_kind`` (NVIDIA H100 SXM data sheet, dense):
#   hbm_bw      — device-memory bandwidth, bytes/s;
#   fp32_flops  — float32 FLOP/s outside the tensor cores (an FMA counts
#                 as two), the compute leg of the ZNCC roofline.
DEVICE_SPECS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bw": 3.35e12, "fp32_flops": 67e12},
}


def device_specs(device_kind: Optional[str] = None) -> Dict[str, float]:
    """Peak specs for ``device_kind`` (default: the first device's).

    Raises ``KeyError`` for a device without published peaks here: a
    roofline share against a guessed peak would be meaningless.
    """
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    if device_kind not in DEVICE_SPECS:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; known: "
            f"{sorted(DEVICE_SPECS)}")
    return dict(DEVICE_SPECS[device_kind])


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a device trace: ``with trace('/tmp/trace'): run()``.

    View with TensorBoard (profile plugin) or Perfetto.  This is the
    subsystem the reference lacked entirely — its timers measured launch
    enqueue (survey §5.1).
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def zncc_roofline(H: int, W: int, D: int, k: int, *,
                  materialize_volume: bool,
                  device_kind: Optional[str] = None) -> Dict[str, float]:
    """Roofline model of one ZNCC frame on the current device.

    Memory leg: mandatory HBM traffic — read both images, plus write (and
    later re-read) the banded volume when it is materialized; the fused
    pipeline writes only four maps.  Compute leg: the separable-moments
    formulation costs ~2·2k adds per output element for the windowed
    cross term plus ~10 elementwise ops (and ~2 transcendentals in the
    fused head, charged at 4 ops each), each charged as one float32 FLOP.

    Returns bounds in seconds and frames/s plus the binding resource.
    """
    spec = device_specs(device_kind)
    elems = H * W * (D + 1)
    image_bytes = 2 * H * W * 4
    if materialize_volume:
        bytes_moved = image_bytes + elems * 4
        ops = elems * (4 * k + 10)
    else:
        bytes_moved = image_bytes + 4 * H * W * 4
        ops = elems * (4 * k + 10 + 2 * 4)
    t_mem = bytes_moved / spec["hbm_bw"]
    t_compute = ops / spec["fp32_flops"]
    t_bound = max(t_mem, t_compute)
    return {
        "t_memory_s": t_mem,
        "t_compute_s": t_compute,
        "bound_s": t_bound,
        "bound_fps": 1.0 / t_bound,
        "bound_by": "memory" if t_mem >= t_compute else "compute",
        "bytes_moved": float(bytes_moved),
        "vector_ops": float(ops),
    }
