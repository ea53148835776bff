"""The program's own spans in the benchmark: the trace reduction names an
idle gap by an open ``repro_torch.*`` span; the readers of the program's
spans on hand-made exports, and ``None`` without them; and the traced
plays of each cell at CPU-test sizes."""
import json

import pytest

from fedbench import harness, program_spans, tiny, trace


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "pid": 1}


def test_a_gap_inside_a_program_span_is_named_by_it(tmp_path):
    """The device idles from 30 to 70 while the host is inside the
    program's ``train.step.grad`` annotation, its last aten op closed:
    the gap reads ``train/repro_torch.train.step.grad``, not
    ``train/python``."""
    events = [
        _ev("fedbench::window", "user_annotation", 0, 100),
        _ev("fedbench::train", "user_annotation", 5, 90),
        _ev("repro_torch.train.step", "user_annotation", 6, 85),
        _ev("repro_torch.train.step.grad", "user_annotation", 7, 70),
        _ev("aten::mm", "cpu_op", 8, 4),
        _ev("k", "kernel", 10, 20, tid=7),
        _ev("k2", "kernel", 70, 30, tid=7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    gaps = dict(trace.reduce(str(path))["breakdown"]["idle_gaps"])
    assert abs(gaps["train/repro_torch.train.step.grad"] - 40e-6) < 1e-12
    assert "train/python" not in gaps


def _span(name, sid, rnd, host=None, device=None, replay=False,
          parent=None):
    return {"name": name, "id": sid, "parent": parent, "round": rnd,
            "host_start_ns": None, "host_end_ns": None, "host_ms": host,
            "device_ms": device, "replay": replay}


def _program():
    spans = []
    # two eager rounds of two steps each
    for r, (a, b) in enumerate(((1.0, 2.0), (3.0, 5.0))):
        spans += [_span("train.step", 10 * r, r, host=4.0 + r),
                  _span("train.step.update", 10 * r + 1, r, host=0.1,
                        device=a),
                  _span("train.step", 10 * r + 2, r, host=6.0 + r),
                  _span("train.step.update", 10 * r + 3, r, host=0.1,
                        device=b)]
    # three chunks' last replays, rounds 3, 7 and 11
    for i, r in enumerate((3, 7, 11)):
        spans += [_span("replay", 100 + 10 * i, r, host=0.01, device=690.0),
                  _span("draw", 101 + 10 * i, r, device=0.2 + i, replay=True),
                  _span("shards", 102 + 10 * i, r, device=3.0, replay=True),
                  _span("noise", 103 + 10 * i, r, device=0.5, replay=True),
                  _span("noise", 104 + 10 * i, r, device=0.5, replay=True)]
    return {"spans": spans, "counters": {}}


READS = {"update_ms.round": 5.5, "update_ms.lm": 5.5,
         "step_host_ms.round": 5.5, "step_host_ms.lm": 5.5,
         "draw_ms.population": 1.2, "shards_ms.population": 3.0,
         "noise_ms.population": 1.0}


@pytest.mark.parametrize("metric", sorted(READS))
def test_each_reader_reads_the_programs_spans(metric):
    cell = harness.Cell(tiny.ROOT, "fedtest-cnn.dense-n20")
    read = cell.reader(metric)
    # update: the rounds' sums 3.0 and 8.0; a step's host ms 4, 5, 6, 7;
    # the replays' draws 0.2, 1.2, 2.2 and their two noise blocks
    assert read({"program": _program()}) == pytest.approx(READS[metric])
    assert read({}) is None
    assert read({"program": {"spans": [], "counters": {}}}) is None


def test_a_round_without_device_times_is_left_out():
    export = {"spans": [_span("train.step.update", 1, 0, host=1.0),
                        _span("train.step.update", 2, 1, device=2.0)],
              "counters": {}}
    assert program_spans.round_sums(export, "train.step.update") == {1: 2.0}
    assert program_spans.round_median(export, "draw") is None


def test_summary_sums_by_name_and_keeps_replays_apart():
    got = program_spans.summary(_program())
    assert got["spans"]["train.step"] == {"calls": 4, "host_ms": 22.0,
                                          "device_ms": 0.0}
    assert got["spans"]["noise@replay"]["calls"] == 6
    assert "noise" not in got["spans"]
    first = program_spans.summary(_program(), 0)["spans"]
    assert set(first) == {"train.step", "train.step.update"}
    assert first["train.step.update"]["device_ms"] == 3.0


@pytest.mark.parametrize("name", sorted(tiny.SHRINK))
def test_traced_plays_record_the_cells_rounds(name):
    """A cell's checked rounds and plays at CPU-test sizes with tracing
    on: the spans the readers read are there (with host times alone on
    the CPU), and tracing ends off and empty."""
    from repro_torch import tracing
    from repro_torch.core.engine.driver import resolve_device
    cell = tiny.cell(name)
    program, setup = program_spans._built(cell, 2 ** 40 + 3,
                                          resolve_device("cpu"), True)
    assert program_spans.summary(setup, 0)["spans"]["train.step"][
        "calls"] == cell.traffic["fed"]["local_steps"]
    record = {"program": program_spans.traced_plays(program, 1)}
    assert not tracing.enabled()
    assert tracing.export() == {"spans": [], "counters": {}}
    spans = program_spans.summary(record["program"])["spans"]
    assert spans["train.step"]["calls"] == (
        program.rounds_per_play * cell.traffic["fed"]["local_steps"])
    assert cell.reader("step_host_ms.x")(record) > 0
    assert cell.reader("update_ms.x")(record) is None
    row = program_spans._window(program, 0.0, True)
    assert row["traced"] and row["spans"] > 0 and row["round_ms"] > 0
    if program.rounds_per_play > 1:
        assert spans["noise"]["calls"] > 0 and "chunk" in spans

