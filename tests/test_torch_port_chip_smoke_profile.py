"""chip_smoke.py's launch check (``by_launch`` over ``device_by_kernel``), on
CPU with torch.profiler replaced by traces given here: a trace in which the
profiler lost every event is taken again, and only traces that are all empty,
or that show another kernel or a second launch a call, fail the check."""
from types import SimpleNamespace

import pytest
import torch

import chip_smoke

REPS = 20  # by_launch's calls a trace (device_by_kernel's default)


def _event(name, us=10.0):
    return SimpleNamespace(device_type=torch.autograd.DeviceType.CUDA, name=name,
                           time_range=SimpleNamespace(elapsed_us=lambda: us))


def _host_event():
    return SimpleNamespace(device_type=torch.autograd.DeviceType.CPU, name="aten::empty",
                           time_range=SimpleNamespace(elapsed_us=lambda: 1.0))


@pytest.fixture
def traces(monkeypatch):
    """The traces the fake profiler hands out, one list of events each, in
    order; what is left of the list after a call shows how many were taken."""
    queue = []

    class FakeProfile:
        def __init__(self, activities):
            self._events = queue.pop(0)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def events(self):
            return self._events

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    return queue


def _one_launch_each(name="decoder_step_kernel<128, true>(Params)"):
    return [_host_event()] + [_event(name) for _ in range(REPS)]


@pytest.mark.parametrize("empty", range(chip_smoke.PROFILE_TRIES))
def test_an_empty_trace_is_taken_again(traces, empty):
    traces.extend([[_host_event()]] * empty + [_one_launch_each(), _one_launch_each()])
    split = chip_smoke.device_by_kernel(lambda: None, reps=REPS)
    assert split == {"decoder_step_kernel": [10.0, 1.0]}
    assert len(traces) == 1  # the trace after the first full one is never taken


@pytest.mark.parametrize("trace, passes", [
    (_one_launch_each(), True),
    (_one_launch_each()[:-1], True),  # a lost event shows as less than one a call
    (_one_launch_each() + _one_launch_each(), False),  # two launches a call
    (_one_launch_each() + [_event("cast_bf16_kernel(Args)")] * REPS, False),  # two kernels
])
def test_by_launch_holds_one_launch_a_call(traces, trace, passes):
    traces.append(trace)
    failures = []
    chip_smoke.by_launch(failures, (("kernel D", lambda: None),))
    assert (failures == []) == passes


def test_by_launch_fails_when_every_trace_is_empty(traces):
    traces.extend([[_host_event()]] * chip_smoke.PROFILE_TRIES)
    failures = []
    chip_smoke.by_launch(failures, (("kernel D", lambda: None),))
    assert failures == ["kernel D: 0 device launches a call over 0 kernels, not 1"]
    assert traces == []
