"""The trace reduction on a small chrome trace made by hand."""
import json

from fedbench import trace


def _ev(name, cat, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_reduce_attributes_kernels_to_their_calls(tmp_path):
    events = [
        _ev("fedbench::window", "user_annotation", 0, 100),
        _ev("fedbench::aggregate", "user_annotation", 10, 10),
        _ev("repro_torch::flash_attention", "cpu_op", 40, 5),
        _ev("aten::add", "cpu_op", 60, 30),
        _ev("cudaLaunchKernel", "cuda_runtime", 12, 1, corr=7),
        _ev("cudaLaunchKernel", "cuda_runtime", 41, 1, corr=8),
        _ev("cudaLaunchKernel", "cuda_runtime", 61, 1, corr=9),
        _ev("wagg", "kernel", 20, 4, tid=7, corr=7),
        _ev("flash", "kernel", 50, 10, tid=7, corr=8),
        _ev("add", "kernel", 55, 10, tid=7, corr=9),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = trace.reduce(str(path), ops=("repro_torch::flash_attention",))
    assert abs(out["window_s"] - 100e-6) < 1e-12
    # busy: [20, 24] and the union [50, 65]
    assert abs(out["busy_s"] - 19e-6) < 1e-12
    assert out["spans"]["aggregate"]["launches"] == 1
    assert abs(out["spans"]["aggregate"]["device_s"] - 4e-6) < 1e-12
    flash = out["spans"]["repro_torch::flash_attention"]
    assert (flash["calls"], flash["launches"]) == (1, 1)
    assert abs(flash["device_s"] - 10e-6) < 1e-12
    names = [k for k, _ in out["breakdown"]["device_ops"]]
    assert names[0] in ("flash", "add")
    # the longest idle gap [0, 20) opens before any span: the host was in
    # the aggregate's span from 10
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert abs(sum(gaps.values()) - 81e-6) < 1e-12


def test_reduce_without_a_window_reads_nothing(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        _ev("k", "kernel", 0, 1)]}))
    assert trace.reduce(str(path)) == {}


def _record(busy_s, plays=2, per_play=1, seconds=10.0, rounds=50):
    return {"trace": {"busy_s": busy_s, "window_s": 3.0, "plays": plays,
                      "span_rounds": plays * per_play,
                      "spans": {"weighted_aggregate": {
                          "device_s": 2e-5, "calls": 2, "launches": 2}}},
            "window": {"seconds": seconds, "rounds": rounds,
                       "rounds_per_play": per_play},
            "work": {"aggregate_bytes": 3.35e4},
            "hbm_bytes_per_s": 3.35e12}


def test_idle_share_is_of_the_untraced_round():
    from fedbench import readers
    # 0.3 s busy over 2 traced rounds against 0.2 s an untraced round
    rec = _record(0.3)
    assert abs(readers.idle_share_of_round(rec) - 25.0) < 1e-9
    # the traced stretch's own share reads the profiler's slower host
    assert abs(readers.idle_share(rec) - 90.0) < 1e-9


def test_aggregate_roofline_reads_the_kernels_own_launches():
    import os
    from fedbench import harness, tiny
    cell = harness.Cell(tiny.ROOT, "fedtest-cnn.dense-n20")
    read = cell.reader("aggregate_roofline.round")
    # a 10-ns bound a round, 2 rounds, 20 us of the kernel's launches
    assert abs(read(_record(0.3)) - 0.1) < 1e-9
    assert not os.path.exists(os.path.join(
        tiny.ROOT, "fedbench", "metrics", "aggregate_roofline.round.py"))
