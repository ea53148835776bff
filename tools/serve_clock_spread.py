"""The spread of the serve phase's host clock on the card, and whether an
earlier phase of ``chip_smoke.py`` moves it.

Each mode runs in a fresh process: the round paths it names (the letters
of ``chip_smoke.PATHS``, joined by commas; ``none`` for no path), then,
for ``+freeze``, ``gc.collect()`` and ``gc.freeze()``, then
``chip_smoke.phase_serve`` twice (qwen2-0.5b at full width in bf16). A
``serve`` line per pass gives the prefill and a decode step on the host
clock beside the device's own time (CUDA graph replay).

  python3 tools/serve_clock_spread.py              # every mode, needs a card
  python3 tools/serve_clock_spread.py E,F+freeze   # one mode
"""
from __future__ import annotations

import gc
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("none", "A,D", "E,F", "E,F+freeze", "A,D,E,F", "none")


def run_mode(mode: str) -> None:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    import chip_smoke as cs

    card = cs.phase_environment(torch)
    if mode == "build":
        cs.phase_build()
        return
    paths = {p[0]: p for p in cs.PATHS}
    names = mode.split("+")[0]
    for name in ([] if names == "none" else names.split(",")):
        cs.phase_path(torch, *paths[name])
    if mode.endswith("+freeze"):
        gc.collect()
        gc.freeze()
    print(f"mode {mode}: {len(gc.get_objects())} objects tracked by gc, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    for rep in range(2):
        _, out = cs.phase_serve(torch, card)
        print(f"serve {mode} pass {rep}: prefill {out['prefill_ms']:.2f} ms, "
              f"decode step {out['decode_ms_per_step']:.3f} ms; device "
              f"{out['prefill_device_ms']:.2f} / "
              f"{out['decode_step_device_ms']:.3f} ms ({card})")


def main(argv) -> int:
    if argv:
        run_mode(argv[0])
        return 0
    for mode in ("build",) + MODES:
        rc = subprocess.run([sys.executable, __file__, mode],
                            cwd=ROOT).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
