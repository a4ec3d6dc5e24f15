import json

from portbench import profile


def test_busy_is_the_union_and_gaps_are_named_by_the_host():
    # device: [0, 10) and [5, 12) overlap, then [20, 25), then [40, 41)
    dev = [(0.0, 10.0, "k1"), (5.0, 7.0, "k2"), (20.0, 5.0, "k1"),
           (40.0, 1.0, "copy")]
    # host: an outer op over [11, 30) with an inner one over [13, 18); a
    # gap at [25, 40) has its middle (32.5) under no operator
    host = [(11.0, 19.0, "aten::outer"), (13.0, 5.0, "aten::item")]
    s = profile.summarize(dev, host)
    assert s.busy_s == 18e-6
    assert s.n_device_ops == 4
    assert s.device_ops == [["k1", 15e-6], ["k2", 7e-6], ["copy", 1e-6]]
    # [12, 20): middle 16 under aten::item; [25, 40): no operator
    assert s.idle_gaps == [["host (no operator)", 15e-6],
                           ["aten::item", 8e-6]]


def test_read_trace_takes_device_and_host_categories(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 0, "dur": 4},
        {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 10, "dur": 2},
        {"ph": "X", "cat": "cpu_op", "name": "aten::sum", "ts": 3, "dur": 6},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunch", "ts": 1,
         "dur": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = profile.read_trace(str(path))
    assert s.n_device_ops == 2 and s.busy_s == 6e-6
    assert s.idle_gaps == [["aten::sum", 6e-6]]
