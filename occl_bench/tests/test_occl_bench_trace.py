"""The trace's reduction: busy time as the union of device intervals,
idle gaps labelled by what the host was in, and each per-layer reader on
a record it can read and on one it cannot."""
import pytest

import occl_bench_tiny  # noqa: F401  (src/ and the root on sys.path)
from occl_bench.harness import manifest, profile



class Event:
    def __init__(self, a, b, name, device):
        self.time_range = type("Range", (), {"start": a, "end": b})()
        self.name = name
        self.device_type = "DeviceType.CUDA" if device else "DeviceType.CPU"


def test_busy_is_the_union_and_annotations_are_not_device_work():
    events = [Event(0, 10, "k_a", True), Event(5, 12, "k_b", True),
              Event(20, 24, "fused_burst_kernel<float>", True),
              Event(30, 32, "fused_burst_kernel<float>", True),
              Event(0, 40, "bench:drive", True),
              Event(0, 40, "bench:drive", False),
              Event(13, 19, "cudaGraphLaunch", False),
              Event(24, 29, "aten::item", False)]
    got = profile.analyse(events, 40e-6, 4)
    assert got["busy_s"] == pytest.approx(18e-6)
    assert got["kernels"] == 4
    assert got["burst_launches"] == 2
    assert got["burst_mean_s"] == pytest.approx(3e-6)
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"drive > cudaGraphLaunch": 8e-6, "drive > aten::item": 6e-6})


def test_program_tracer_ranges_are_not_device_work():
    events = [Event(0, 10, "k_a", True),
              Event(0, 30, "occl:occl.chunk", True),
              Event(0, 30, "occl:occl.chunk", False),
              Event(20, 24, "k_b", True)]
    got = profile.analyse(events, 30e-6, 1)
    assert got["busy_s"] == pytest.approx(14e-6)
    assert got["kernels"] == 2
    assert dict(got["idle_gaps"]) == pytest.approx(
        {"- > occl:occl.chunk": 10e-6})


def test_no_device_event_reads_nothing():
    assert profile.analyse([Event(0, 1, "aten::add", False)], 1.0, 1) \
        is None


def record(profiled: bool) -> dict:
    prof = {"busy_s": 0.2, "wall_s": 0.5, "supersteps": 256,
            "burst_mean_s": 2.5e-6, "kernels": 1, "device_ops": [],
            "idle_gaps": [], "burst_launches": 256} if profiled else None
    return {"steps": 5, "window_s": 55.0, "supersteps": 50000,
            "overlap_supersteps": 320,
            "spans": {"drive": 45.0, "flush": 2.0, "read": 1.0,
                      "tick": 0.0, "runtime": 48.0},
            "profile": prof, "step_flops": 1.2e12,
            "peak_flops_per_s": 989e12}


EXPECTED = {"supersteps_per_step": 10000.0,
            "hidden_superstep_share": 0.0064,
            "staging_s_per_step": 0.6,
            "daemon_ms_per_superstep": 0.86,
            "device_ms_per_superstep": 0.2e3 / 256,
            "device_idle_share": 0.6,
            "fused_burst_us": 2.5,
            "host_compute_s_per_step": 1.4,
            "step_mfu": 100 * 1.2e12 / 11.0 / 989e12}


@pytest.mark.parametrize("metric", sorted(
    p.stem for p in (manifest.BENCH / "metrics").glob("*.py")))
def test_reader_reads_its_record(metric):
    assert manifest.reader(metric).read(record(True)) == pytest.approx(
        EXPECTED[metric])


@pytest.mark.parametrize("metric", ["device_ms_per_superstep",
                                    "device_idle_share",
                                    "fused_burst_us"])
def test_reader_without_a_trace_reads_nothing(metric):
    assert manifest.reader(metric).read(record(False)) is None


class Runtime:
    """Counters as ``OcclRuntime.stats()`` gives them."""

    def __init__(self):
        self.calls = 0

    def stats(self):
        import numpy as np

        self.calls += 1
        n = self.calls
        z = np.zeros(4, np.int64)
        return {"supersteps": np.arange(4) * n, "overlap_supersteps": z,
                "preempts": np.full((4, 2), n), "staging_read_bytes": 10 * n,
                "burst_slices": 8, "graph_kernel_nodes": {16: 49},
                "launch_history": [n], "lane_caps": np.ones(3, bool)}


@pytest.mark.parametrize("min_steps", [1, 2, 3])
def test_window_of_no_length_holds_its_least_steps(min_steps):
    from occl_bench.harness.window import Window

    w = Window(0.0, "cpu")
    w.start(Runtime(), min_steps)
    done = [w.step_done() for _ in range(min_steps)]
    assert done == [False] * (min_steps - 1) + [True]
    assert w.steps == min_steps and w.window_s >= 0


def test_window_counts_every_scalar_counter():
    from occl_bench.harness.window import Window

    w = Window(0.0, "cpu")
    w.start(Runtime())
    assert w.step_done()
    # clocks by their largest rank, arrays summed, scalars as they are;
    # maps, lists and flags are no counters
    assert w.deltas() == {"supersteps": 3, "overlap_supersteps": 0,
                          "preempts": 8, "staging_read_bytes": 10,
                          "burst_slices": 0}
