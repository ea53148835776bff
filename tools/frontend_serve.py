"""Slice 13's part of ``chip_smoke.py`` alone, on one card: the kernels
built, ``flash_attention`` and ``decode_attention`` held against their
plain versions (the new cases among the old: groups 8 / 8 and 32 / 8,
S = 384 and S = 1 against T = 1,500 non-causal, a 1,569-row decode
cache), both timed at the shapes phases W and V give them
(``phase_frontend_times``), then phases W (``whisper-base``) and V
(``pixtral-12b``) served at full width and depth, every check of the
smoke held. Run from the root of the repository:

  python3 tools/frontend_serve.py

Prints what the smoke prints for these phases and, last, one JSON line
of their numbers; exits non-zero on the first failed check.
"""
from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("frontend_serve: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    t0 = time.perf_counter()
    card = cs.phase_environment(torch)
    _, peaks = cs.card_peaks(torch)
    cs.phase_build()
    cs.check_flash_attention(torch)
    cs.check_decode_attention(torch)
    rows = cs.phase_frontend_times(torch, peaks)
    out = {label: cs.phase_frontend_serve(torch, card, peaks, label, argv,
                                          n_ref)
           for label, argv, n_ref in cs.FRONTEND_SERVES}
    print(json.dumps({"card": card, "rows": rows, "frontend": out,
                      "seconds": time.perf_counter() - t0}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
