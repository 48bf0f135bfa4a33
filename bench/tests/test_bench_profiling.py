"""The traced run's record check: a profiled window is kept only where each
counted kernel's records equal its counted launches.  On the CPU with fake
profiler events, ``ssd_scan``'s among them (of its three kernels, the state
pass is the one every call launches); on the card, the records of real
``ssd_scan`` calls against its launch counter."""

import pytest
import torch

from _tiny import BENCH  # noqa: F401  (puts src/ and bench/ on the path)
from harness import profiling

SSD = ("void (anonymous namespace)::ssd_chunk_state_kernel<float>(Params)",
       "void (anonymous namespace)::ssd_state_pass_kernel(Params)",
       "void (anonymous namespace)::ssd_chunk_scan_kernel<float>(Params)")


class _Range:
    def __init__(self, start, end):
        self.start, self.end = start, end


class _Event:
    def __init__(self, name, start, end, device=True):
        self.name = name
        self.time_range = _Range(start, end)
        self.device_type = (torch.autograd.DeviceType.CUDA if device
                            else torch.autograd.DeviceType.CPU)
        self.is_user_annotation = False


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def _window(calls: int, lost: int):
    """``calls`` ssd_scan calls, each its three kernels, with ``lost`` of the
    state pass's records missing, inside the profiled window's host range."""
    events, t = [_Event(profiling.WINDOW_LABEL, 0.0, 1000.0, device=False)], 10.0
    for i in range(calls):
        for name in SSD:
            if name == SSD[1] and i < lost:
                continue
            events.append(_Event(name, t, t + 5.0))
            t += 10.0
    return _Prof(events)


@pytest.mark.parametrize("calls, lost, kept", [(3, 0, True), (3, 1, False), (1, 1, False)])
def test_a_window_short_of_ssd_scan_records_is_refused(calls, lost, kept):
    prof, short = profiling.read(_window(calls, lost), {"ssd_scan": calls}, 0, 1, 1.0)
    if kept:
        assert short is None
        assert prof.launches == {"ssd_scan": calls}
        assert prof.groups["ssd_scan"] == pytest.approx(3 * calls * 5.0e-6)
        assert prof.window_s == pytest.approx(1000.0e-6)
    else:
        assert prof is None
        assert short == {"ssd_scan": f"{calls - lost} records of {calls} launches"}


@pytest.mark.cuda
def test_ssd_scan_records_match_its_launches_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the profiler's records of the CUDA kernels")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.ssd_scan.kernel import ssd_scan

    g = torch.Generator(device="cuda").manual_seed(0)
    b, t, h, p, n = 2, 300, 4, 64, 128
    xdt = torch.randn(b, t, h, p, generator=g, device="cuda")
    a = -torch.rand(b, t, h, generator=g, device="cuda")
    bmat = torch.randn(b, t, n, generator=g, device="cuda", dtype=torch.bfloat16)
    cmat = torch.randn(b, t, n, generator=g, device="cuda", dtype=torch.bfloat16)
    ssd_scan(xdt, a, bmat, cmat)  # builds the kernel
    torch.cuda.synchronize()
    before = launch_counts().get("ssd_scan", 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            ssd_scan(xdt, a, bmat, cmat)
        torch.cuda.synchronize()
    launches = {"ssd_scan": launch_counts()["ssd_scan"] - before}
    assert launches == {"ssd_scan": 5}
    got, short = profiling.read(prof, launches, 0, 0, 1.0)
    assert short is None, short
    names = {k: v[1] for k, v in got.kernels.items() if "ssd_" in k}
    assert [v for k, v in names.items() if "ssd_state_pass_kernel" in k] == [5], names
    assert sum(names.values()) == 15, names  # chunk state, state pass, chunk scan: once a call
