"""The retry knobs: ``MOSAIC_RETRY_ATTEMPTS``, ``_BASE_S``, ``_MAX_S`` and
``_BUDGET_S`` read by `RetryPolicy.from_env` whenever a caller passes no
policy, as the reference reads them.

Each case runs one function that raises a transient error a set number
of times through the port's ``call_with_retry`` and the reference's,
under the same environment and ``MOSAIC_RETRY_SEED``. The call count, the
outcome's type and every backoff delay must be the same; the delays bit
for bit."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from mosaic_tpu.runtime import errors as ref_errors
from mosaic_tpu.runtime import retry as ref_retry
from mosaic_tpu_torch.runtime import errors, retry
from mosaic_tpu_torch.runtime import telemetry

KNOBS = (
    "MOSAIC_RETRY_ATTEMPTS", "MOSAIC_RETRY_BASE_S",
    "MOSAIC_RETRY_MAX_S", "MOSAIC_RETRY_BUDGET_S",
)

#: (case id, environment, failures before success)
CASES = [
    ("unset-recovers", {}, 1),
    ("unset-exhausts", {}, 10),
    ("attempts-1", {"MOSAIC_RETRY_ATTEMPTS": "1"}, 1),
    ("attempts-2-recovers", {"MOSAIC_RETRY_ATTEMPTS": "2"}, 1),
    ("attempts-5", {"MOSAIC_RETRY_ATTEMPTS": "5"}, 10),
    ("attempts-float-text", {"MOSAIC_RETRY_ATTEMPTS": "2.7"}, 10),
    ("attempts-malformed", {"MOSAIC_RETRY_ATTEMPTS": "three"}, 10),
    ("base", {"MOSAIC_RETRY_BASE_S": "0.2", "MOSAIC_RETRY_ATTEMPTS": "4"}, 10),
    ("base-malformed", {"MOSAIC_RETRY_BASE_S": "fast"}, 10),
    ("max", {"MOSAIC_RETRY_MAX_S": "0.07", "MOSAIC_RETRY_ATTEMPTS": "6"}, 10),
    ("max-malformed", {"MOSAIC_RETRY_MAX_S": "", "MOSAIC_RETRY_ATTEMPTS": "6"}, 10),
    ("budget", {"MOSAIC_RETRY_BUDGET_S": "0.1", "MOSAIC_RETRY_ATTEMPTS": "9"}, 10),
    ("budget-malformed", {"MOSAIC_RETRY_BUDGET_S": "1e", "MOSAIC_RETRY_ATTEMPTS": "9"}, 10),
]


def _run(mod, err_mod, failures):
    """(calls, outcome type name, delays, attempts) of one retried call."""
    calls = []
    delays = []

    def fn():
        calls.append(1)
        if len(calls) <= failures:
            raise err_mod.TransientDeviceError("planned transient fault")
        return "ok"

    try:
        out = mod.call_with_retry(fn, label="retry_env", sleep=delays.append)
        outcome, attempts = type(out).__name__, None
    except err_mod.RetryExhausted as e:
        outcome, attempts = type(e).__name__, e.attempts
    return len(calls), outcome, delays, attempts


@pytest.fixture
def knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MOSAIC_RETRY_SEED", "77")

    def set_env(env):
        for k, v in env.items():
            monkeypatch.setenv(k, v)

    return set_env


@pytest.mark.parametrize("case,env,failures", CASES, ids=[c[0] for c in CASES])
def test_knob_matches_the_reference(knobs, case, env, failures):
    knobs(env)
    with telemetry.capture():
        got = _run(retry, errors, failures)
    want = _run(ref_retry, ref_errors, failures)
    assert got[:2] == want[:2]
    assert got[3] == want[3]
    assert np.array(got[2]).tobytes() == np.array(want[2]).tobytes()
    assert len(got[2]) == got[0] - 1  # a sleep between attempts, none after


@pytest.mark.parametrize("case,env,failures", CASES, ids=[c[0] for c in CASES])
def test_from_env_equals_the_references(knobs, case, env, failures):
    knobs(env)
    got = dataclasses.astuple(retry.RetryPolicy.from_env())
    want = dataclasses.astuple(ref_retry.RetryPolicy.from_env())
    assert np.array(got, dtype=np.float64).tobytes() == np.array(want, dtype=np.float64).tobytes()


def test_one_attempt_raises_after_one_call(knobs):
    """The fault this pins: with ``MOSAIC_RETRY_ATTEMPTS=1`` and one
    transient error, the port answered after a second call where the
    reference raises after the first."""
    knobs({"MOSAIC_RETRY_ATTEMPTS": "1"})
    calls, outcome, delays, attempts = _run(retry, errors, 1)
    assert (calls, outcome, delays, attempts) == (1, "RetryExhausted", [], 1)


def test_unset_knobs_make_three_attempts(knobs):
    calls, outcome, delays, attempts = _run(retry, errors, 10)
    assert (calls, outcome, attempts, len(delays)) == (3, "RetryExhausted", 3, 2)


def test_explicit_policy_beats_the_knobs(knobs):
    knobs({"MOSAIC_RETRY_ATTEMPTS": "1"})
    calls = []

    def fn():
        calls.append(1)
        if len(calls) < 3:
            raise errors.TransientDeviceError("planned transient fault")
        return "ok"

    with telemetry.capture():
        out = retry.call_with_retry(
            fn, policy=retry.RetryPolicy(max_attempts=3), sleep=lambda s: None
        )
    assert out == "ok" and len(calls) == 3


@pytest.mark.parametrize("attempts", ["1", "2", "4"])
def test_fallback_degrades_after_the_knobs_attempts(knobs, attempts):
    knobs({"MOSAIC_RETRY_ATTEMPTS": attempts})

    def fn():
        raise errors.TransientDeviceError("planned transient fault")

    def ref_fn():
        raise ref_errors.TransientDeviceError("planned transient fault")

    with telemetry.capture() as events:
        out = retry.call_with_retry(fn, fallback=lambda: 5, sleep=lambda s: None)
    ref = ref_retry.call_with_retry(ref_fn, fallback=lambda: 5, sleep=lambda s: None)
    assert isinstance(out, errors.DegradedResult)
    assert out.attempts == ref.attempts == int(attempts)
    assert [e["attempts"] for e in events if e["event"] == "degraded"] == [int(attempts)]
