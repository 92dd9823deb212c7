"""Failure detection and recovery for production serving/training.

The reference is fail-fast and single-process: `TORCH_CHECK` macros and
one shape assert are its entire failure story (reference:
custma/include/stereo_matching.hpp:20-33, custma/src/stereo_matching.cpp:28).
A deployed service needs more, and this module supplies the pieces
that make sense for a stateless vision op (survey §5.3):

* **transient-fault classification** — device unavailability, preemption
  and collective timeouts surface as runtime errors whose retry is safe for a
  stateless op (same inputs → same outputs; no optimizer state to
  corrupt);
* **bounded retry with backoff** (:func:`with_retries`) — wraps any
  callable; persistent faults re-raise after the budget;
* **device health probe** (:func:`device_healthcheck`) — a tiny jitted
  computation with a value check, for readiness/liveness endpoints;
* **training recovery** is checkpoint-based restart, already provided by
  the orbax save/restore loop (examples/train.py) — elastic in-job
  recovery is intentionally out of scope (the op is stateless; a
  restarted worker loses nothing but warm caches).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional, TypeVar

T = TypeVar("T")

# Status codes that mark a PJRT runtime error as plausibly transient:
# device preemption or loss, and collective timeouts.
TRANSIENT_MARKERS: tuple = (
    "UNAVAILABLE",
    "DEADLINE_EXCEEDED",
    "ABORTED",
)


def is_transient_device_error(exc: BaseException,
                              markers: Iterable[str] = TRANSIENT_MARKERS
                              ) -> bool:
    """Heuristic: is ``exc`` a fault worth retrying?

    Programming errors (shape/type/value errors, tracer leaks) are never
    transient; runtime errors are classified by message markers.
    """
    if isinstance(exc, (ValueError, TypeError, KeyError, AssertionError)):
        return False
    msg = str(exc)
    return any(m in msg for m in markers)


def with_retries(
    fn: Callable[..., T],
    *,
    retries: int = 2,
    backoff_s: float = 0.5,
    backoff_factor: float = 2.0,
    classify: Callable[[BaseException], bool] = is_transient_device_error,
    on_retry: Optional[Callable[[int, BaseException], None]] = None,
) -> Callable[..., T]:
    """Wrap ``fn`` with bounded retry on transient device faults.

    Non-transient errors raise immediately; transient ones retry up to
    ``retries`` times with exponential backoff, then re-raise.
    ``on_retry(attempt, exc)`` is called before each retry (logging /
    metrics hook).
    """

    def wrapped(*args, **kwargs) -> T:
        delay = backoff_s
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except BaseException as exc:  # noqa: B036 — classified below
                if attempt >= retries or not classify(exc):
                    raise
                if on_retry is not None:
                    on_retry(attempt + 1, exc)
                time.sleep(delay)
                delay *= backoff_factor
        raise AssertionError("unreachable")

    return wrapped


def device_healthcheck(device=None, tolerance: float = 1e-6) -> bool:
    """Run a tiny computation on ``device`` and verify the answer.

    Returns True iff the device executed correctly — a readiness probe
    that catches wedged runtimes that still accept dispatches.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    try:
        if device is None:
            device = jax.devices()[0]
        x = jax.device_put(jnp.arange(8.0, dtype=jnp.float32), device)
        y = jax.jit(lambda v: (v * v).sum())(x)
        return bool(abs(float(y) - 140.0) <= tolerance)
    except Exception:
        return False
