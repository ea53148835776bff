"""Nothing the benchmark runs loads JAX or the JAX package: a fresh
interpreter runs a cell's round at CPU-test size and then looks at the
top-level names of every loaded module, whole."""
import json
import os
import subprocess
import sys

from fedbench import harness, tiny

SCRIPT = """
import json, sys, time, torch
torch.set_num_threads(1)
from fedbench import harness, readings, tiny
from fedbench.reference import cnn, moe  # noqa: F401
for name in sorted(tiny.SHRINK):
    harness.run(tiny.cell(name), 5, 0.0, False, torch.device("cpu"),
                time.perf_counter(), log=lambda *_: None)
print(json.dumps(harness.forbidden_modules()))
"""


def test_nothing_loads_jax_or_the_jax_package():
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join([tiny.ROOT,
                                          os.path.join(tiny.ROOT, "src")])}
    out = subprocess.run([sys.executable, "-c", SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=tiny.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_names_compare_whole():
    assert set(harness.FORBIDDEN) == {"jax", "jaxlib", "flax", "repro"}
    sys.modules["repro_torch_like"] = sys.modules["os"]
    try:
        assert "repro_torch_like" not in harness.forbidden_modules()
    finally:
        del sys.modules["repro_torch_like"]
