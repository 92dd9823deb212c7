"""Failure detection / recovery utilities (utils/failsafe.py).

Survey §5.3: the reference is fail-fast with no recovery story; these
tests are the spec for the retry/health subsystem the serving path uses.
"""

import numpy as np
import pytest

from custereomatching_tpu.utils.failsafe import (
    device_healthcheck,
    is_transient_device_error,
    with_retries,
)


class _FakeDeviceError(RuntimeError):
    pass


def test_classification():
    assert is_transient_device_error(
        _FakeDeviceError("UNAVAILABLE: device preempted"))
    assert is_transient_device_error(
        _FakeDeviceError("DEADLINE_EXCEEDED: all-reduce timed out"))
    assert not is_transient_device_error(ValueError("bad shape"))
    assert not is_transient_device_error(RuntimeError("INVALID_ARGUMENT"))


def test_retry_recovers_from_transient_faults():
    calls = {"n": 0}
    seen = []

    def flaky(x):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise _FakeDeviceError("UNAVAILABLE: transient")
        return x * 2

    fn = with_retries(flaky, retries=3, backoff_s=0.001,
                      on_retry=lambda a, e: seen.append(a))
    assert fn(21) == 42
    assert calls["n"] == 3
    assert seen == [1, 2]


def test_retry_budget_exhausted_reraises():
    def always_down(_):
        raise _FakeDeviceError("UNAVAILABLE: still down")

    fn = with_retries(always_down, retries=2, backoff_s=0.001)
    with pytest.raises(_FakeDeviceError):
        fn(0)


def test_nontransient_raises_immediately():
    calls = {"n": 0}

    def broken(_):
        calls["n"] += 1
        raise ValueError("shape mismatch")

    fn = with_retries(broken, retries=5, backoff_s=0.001)
    with pytest.raises(ValueError):
        fn(0)
    assert calls["n"] == 1


def test_device_healthcheck():
    assert device_healthcheck() is True


def test_engine_retry_and_health():
    """Engine with retries survives an injected transient fault."""
    from custereomatching_tpu.config import StereoConfig
    from custereomatching_tpu.models.engine import StereoEngine

    eng = StereoEngine(StereoConfig(kernel_size=5, num_disparities=6,
                                    backend="xla"),
                       buckets=[(32, 64)], retries=2)
    assert eng.healthy()

    # Inject a transient failure in front of the compiled fn.
    inner = eng._fn
    state = {"fail": 1}

    def flaky(c, p):
        if state["fail"]:
            state["fail"] -= 1
            raise _FakeDeviceError("UNAVAILABLE: injected")
        return inner(c, p)

    from custereomatching_tpu.utils.failsafe import with_retries as wr

    eng._fn = wr(flaky, retries=2, backoff_s=0.001)
    rng = np.random.default_rng(0)
    cam = rng.random((24, 48), dtype=np.float32)
    out = eng.infer(cam, cam)
    assert out.disparity.shape == (24, 48)
    assert state["fail"] == 0
