"""Seeds derived from a run's seed, for draws that must not come from the
round's carried generator (a schedule that is a pure function of the run
seed and a counter, so a resumed run draws what an unbroken one does)."""
from __future__ import annotations

import numpy as np


def derived_seed(*parts: int) -> int:
    """A 63-bit ``torch.Generator`` seed that is a pure function of the
    non-negative integers ``parts`` (numpy's ``SeedSequence`` mixes them),
    the same in every process."""
    lo, hi = np.random.SeedSequence([int(p) for p in parts]).generate_state(
        2, np.uint32)
    return int(lo) | (int(hi) & 0x7FFFFFFF) << 32
