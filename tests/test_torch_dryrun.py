"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU, in one
subprocess: the ``"fake"`` process group it runs on is process-global,
and the pod tests run gloo groups in other processes.

* ``lower_one("mamba2-2.7b", "long_500k", multi_pod=False,
  extrapolate=False)`` is ``ok`` on 256 chips with collectives above 0
  (the reference's ``tests/test_dryrun.py`` case), at full width and
  depth;
* on a fake (2, 2) mesh, one sharded matmul's per-device FLOPs and
  all-gather bytes equal a hand count, the FLOPs of the local shards and
  not of the global product;
* ``extrapolated_costs`` from 2 and 4 layer units (its defaults) equals
  the full count of a 6-unit config (a reduced qwen2 prefill on the
  (2, 2) mesh): the layer stack is a Python loop, so every layer counts
  alike;
* whisper at ``long_500k`` is ``skipped`` with the reason that names 448
  (no mesh needed: it returns before one is made).
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.launch.dryrun import lower_one  # noqa: E402

SCRIPT = r"""
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from repro_torch.config import InputShape, reduce_for_smoke
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.roofline import CostCounter

torch.set_num_threads(1)
out = {}
rec = dr.lower_one("mamba2-2.7b", "long_500k", multi_pod=False,
                   extrapolate=False)
out["mamba"] = {"status": rec["status"], "chips": rec.get("num_chips"),
                "coll": sum(rec.get("collectives", {}).values())}

with make_host_mesh((2, 2), ("data", "model")) as mesh:
    mode = FakeTensorMode()
    with mode:
        x = distribute_tensor(torch.empty(8, 16), mesh, [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(16, 12), mesh, [Shard(0), Shard(1)])
    counter = CostCounter()
    counter.track_inputs([x, w])
    with mode, counter:
        y = x @ w
    out["matmul"] = dict(counter.summary(), local=list(y._local_tensor.shape))

    cfg = reduce_for_smoke(get_config("qwen2-0.5b")).replace(num_layers=6)
    shape = InputShape("prefill_small", 32, 4, "prefill")
    full = dr._lower_compile(cfg, shape, mesh)
    ext = dr.extrapolated_costs(cfg, shape, mesh)
    out["extrapolation"] = {
        "full": {k: full[k] for k in ("flops", "bytes", "coll_bytes",
                                      "collectives")},
        "extrapolated": {k: ext[k] for k in ("flops", "bytes", "coll_bytes",
                                             "collectives")}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def dryrun():
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-W", "ignore", "-c", SCRIPT],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_dryrun_runs_on_the_production_mesh(dryrun):
    out = dryrun["mamba"]
    assert out["status"] == "ok"
    assert out["chips"] == 256
    assert out["coll"] > 0          # a sharded program must communicate


def test_sharded_matmul_counts_match_a_hand_count(dryrun):
    got = dryrun["matmul"]
    # x [8, 16] rows over data (2), w [16, 12] rows over data and columns
    # over model (2): DTensor gathers w's rows over data (each device then
    # holds [16, 6], 16 * 6 * 4 B out), and a device multiplies its
    # [4, 16] rows by [16, 6]: 2 * 4 * 16 * 6 FLOPs, not the global
    # product's 2 * 8 * 16 * 12
    assert got["local"] == [4, 6]
    assert got["flops"] == 2 * 4 * 16 * 6
    assert got["collectives"] == {"all-gather": 16 * 6 * 4}
    assert got["coll_bytes"] == 16 * 6 * 4


def test_extrapolation_equals_the_full_depth_count(dryrun):
    got = dryrun["extrapolation"]
    assert got["full"]["flops"] > 0 and got["full"]["coll_bytes"] > 0
    assert got["extrapolated"] == got["full"]


def test_whisper_long_context_is_skipped_with_reason():
    rec = lower_one("whisper-base", "long_500k", multi_pod=False)
    assert rec["status"] == "skipped"
    assert "448" in rec["reason"]
