"""The device trace's reader on recorded events: busy time as the union
of the operations' intervals, idle gaps named by the host's stage."""

from types import SimpleNamespace

from t4bench import trace


class _Prof:
    def __init__(self, spans):
        from torch.autograd import DeviceType

        self._events = [SimpleNamespace(
            device_type=DeviceType.CUDA, name=name,
            time_range=SimpleNamespace(start=a * 1e6, end=b * 1e6))
            for name, a, b in spans]

    def events(self):
        return self._events


def test_busy_idle_and_gaps():
    window = [{"t0": 100.0, "t1": 110.0, "stderr": [
        (103.0, "[stage-time] extract: 3.000s"),
        (108.0, "[stage-time] assemble: 5.000s"),
        (110.0, "[stage-time] annotate: 2.000s")]}]
    # Profiler times count from 100.0 on the host clock.
    prof = _Prof([("k", 4.0, 4.5), ("copy", 4.25, 5.0), ("k", 9.0, 9.5)])
    out = trace.summarise(prof, 100.0, 100.0, 110.0, window)
    assert out["busy_s"] == 1.5
    assert out["window_s"] == 10.0
    ops = dict(out["breakdown"]["device_ops"])
    assert ops == {"k": 1.0, "copy": 0.75}
    gaps = out["breakdown"]["idle_gaps"]
    assert gaps[0] == ["extract", 4.0]
    assert gaps[1] == ["assemble", 4.0]
    assert gaps[2] == ["annotate", 0.5]
    assert trace.stage_at(window, 99.0) == "between samples"
