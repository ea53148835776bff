"""The benchmark finds its configurations, traffic, cells and metrics by
name, and a cell and a metric added as new files run without an edit to
any file that is there. ``BENCHMARK.json`` keeps to its contract."""
import json
import os
import re
import shutil
import time

from fedbench import harness, tiny

ROOT = tiny.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_has_its_file():
    bench = _bench()
    here = os.path.join(ROOT, "fedbench")
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"] == f"fedbench/configs/{c['name']}.json"
    for w in bench["workloads"]:
        for part in (("workloads", w["name"]), ("traffic", w["traffic"]),
                     ("configs", w["config"])):
            assert os.path.exists(os.path.join(here, part[0],
                                               f"{part[1]}.json"))
        cell = harness.Cell(ROOT, w["name"])
        for traced in (False, True):
            for m in cell.metrics(traced):
                assert callable(cell.reader(m["name"]))


def test_a_metric_without_a_file_takes_its_quantitys_reader():
    cell = harness.Cell(ROOT, "granite-moe-1b-a400m.lm-round")
    one, two = cell.reader("train_ms.lm"), cell.reader("train_ms.round")
    record = {"steps": {"train": [3.0, 1.0, 2.0], "cross_test": [5.0]}}
    assert one(record) == two(record) == 2.0


def test_benchmark_json_keeps_to_its_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    ends = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in ends
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in ends
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        reported = [m for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2
    for m in bench["per_layer"] + bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell and a metric:
    new files and new entries in ``BENCHMARK.json``, no file edited."""
    shutil.copytree(os.path.join(ROOT, "fedbench"),
                    os.path.join(tmp_path, "fedbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    base = "fedtest-cnn.dense-n20"
    entry = [w for w in bench["workloads"] if w["name"] == base][0]
    here = os.path.join(tmp_path, "fedbench")
    with open(os.path.join(here, "traffic", f"{entry['traffic']}.json")) as f:
        traffic = json.load(f)
    traffic["fed"]["num_malicious"] = 0
    traffic["fed"]["attack"] = "none"
    with open(os.path.join(here, "traffic", "honest-n20.json"), "w") as f:
        json.dump(traffic, f)
    shutil.copy(os.path.join(here, "workloads", f"{base}.json"),
                os.path.join(here, "workloads", "fedtest-cnn.honest.json"))
    with open(os.path.join(here, "metrics", "rounds_done.py"), "w") as f:
        f.write("def read(record):\n    return record['window']['rounds']\n")
    bench["workloads"].append({**entry, "name": "fedtest-cnn.honest",
                               "traffic": "honest-n20"})
    bench["per_layer"].append({"name": "rounds_done", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "round driver", "moves": "round_ms",
                               "workloads": ["fedtest-cnn.honest"]})
    for m in bench["end_to_end"]:
        if base in m.get("workloads", []):
            m["workloads"].append("fedtest-cnn.honest")
    with open(os.path.join(tmp_path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    import torch
    cell = harness.Cell(str(tmp_path), "fedtest-cnn.honest",
                        shrink=tiny.CNN, config_shrink=tiny.CNN_MODEL)
    out = harness.run(cell, 11, 0.2, True, torch.device("cpu"),
                      time.perf_counter(), log=lambda *_: None)
    assert out["correct"], out["numbers"]
    traced = harness.read_metrics(cell, out["record"], True)
    assert traced["rounds_done"]["value"] == out["attempted"]
