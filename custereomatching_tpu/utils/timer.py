"""Wall-clock timing utilities and a JAX-correct benchmark harness.

The reference's entire profiling subsystem is a wall-clock ``Timer``
context manager (custma/utils.py:13-87, itself derived from OpenMMLab
mmcv's Apache-2.0 ``Timer``) whose CUDA timings are wrong: it never
synchronizes the device, so it measures async launch enqueue, not kernel
runtime (used at examples/verify.py:65-68).  This module keeps only the
reference Timer's *surface* (``with Timer("fwd {:.6f}s")``,
``since_start`` / ``since_last_check``, ``TimerError``) so user code
ports over; the implementation is a lap-stamp design of our own, and the
real device-measurement story is :func:`benchmark`: every timed call
ends in ``jax.block_until_ready``, after warmup calls that absorb
compilation.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, List, Optional

import jax


class TimerError(Exception):
    """Raised when a Timer is queried while not running."""


class Timer:
    """Context-manager wall-clock timer (API-compatible with
    ``custma.Timer``, custma/utils.py:13-87).

    Internally a list of monotonic lap stamps: index 0 is the origin,
    every query appends a stamp, and the two query methods are just
    differences against the first / previous stamp.  An empty lap list
    means "not running".

    Note: this measures *host* wall-clock. For device work use
    :func:`benchmark` — the reference's misuse of wall-clock timers on
    async devices is exactly the flaw this package avoids.
    """

    def __init__(self, print_tmpl: Optional[str] = None, start: bool = True):
        if print_tmpl is None:
            print_tmpl = "{:.3f}"
        elif "{" not in print_tmpl:
            print_tmpl = f"{print_tmpl} {{:.3f}}"
        self.print_tmpl = print_tmpl
        self._laps: List[float] = []
        if start:
            self.start()

    @property
    def is_running(self) -> bool:
        return bool(self._laps)

    def __enter__(self) -> "Timer":
        self.start()
        return self

    def __exit__(self, exc_type, exc_value, traceback) -> None:
        print(self.print_tmpl.format(self.since_last_check()))
        self._laps.clear()

    def start(self) -> None:
        """Start the timer, or reset the last-check stamp if running."""
        self._laps.append(time.perf_counter())
        self._trim()

    def _stamp(self) -> None:
        if not self._laps:
            raise TimerError("timer is not running")
        self._laps.append(time.perf_counter())
        self._trim()

    def _trim(self) -> None:
        # Queries only ever read the origin, previous, and last stamps;
        # drop the middle so a long-lived Timer polled per frame (the
        # reference-compatible serving pattern) stays O(1) memory.
        if len(self._laps) > 3:
            del self._laps[1:-2]

    def since_start(self) -> float:
        self._stamp()
        return self._laps[-1] - self._laps[0]

    def since_last_check(self) -> float:
        self._stamp()
        return self._laps[-1] - self._laps[-2]


def benchmark(
    fn: Callable[..., Any],
    *args: Any,
    warmup: int = 2,
    iters: int = 10,
    **kwargs: Any,
) -> Dict[str, float]:
    """Measure a JAX callable correctly.

    Runs ``warmup`` calls (absorbing compilation), then ``iters`` timed
    calls, each fenced with ``jax.block_until_ready`` so device execution —
    not launch enqueue — is measured (fixing the reference's Timer flaw,
    see module docstring).

    Returns a dict with ``median_s``, ``mean_s``, ``min_s``, ``max_s``,
    ``std_s`` and ``iters``.
    """

    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))

    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        samples.append(time.perf_counter() - t0)

    return {
        "median_s": statistics.median(samples),
        "mean_s": statistics.fmean(samples),
        "min_s": min(samples),
        "max_s": max(samples),
        "std_s": statistics.pstdev(samples),
        "iters": float(iters),
    }
