"""What several metric readers share: a record's window and trace
arithmetic. A reader that finds nothing to read returns ``None``."""
from __future__ import annotations

import statistics
from typing import Optional


def round_s(record: dict) -> float:
    """The window's seconds over the rounds it completed."""
    w = record["window"]
    return w["seconds"] / w["rounds"]


def mfu(record: dict) -> Optional[float]:
    """The window's model FLOPs over its time, as a % of the peak."""
    flops = record["work"].get("round_flops")
    if not flops:
        return None
    return 100.0 * flops / round_s(record) / record["peak_flops"]


def step_ms(record: dict, step: str) -> Optional[float]:
    """The median device ms of a step a round (CUDA events)."""
    steps = record.get("steps") or {}
    times = steps.get(step)
    return statistics.median(times) if times else None


def idle_share(record: dict) -> Optional[float]:
    """1 - the device's busy seconds over the traced stretch's seconds.
    The profiler slows the host's side of an eager round, so a
    host-paced round reads more idle traced than it runs."""
    tr = record.get("trace") or {}
    if not tr.get("busy_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def idle_share_of_round(record: dict) -> Optional[float]:
    """1 - the device's busy seconds a round in the traced stretch over
    the untraced window's seconds a round."""
    tr = record.get("trace") or {}
    if not tr.get("busy_s"):
        return None
    rounds = tr["plays"] * record["window"]["rounds_per_play"]
    return 100.0 * (1.0 - tr["busy_s"] / rounds / round_s(record))


def span(record: dict, name: str) -> Optional[dict]:
    tr = record.get("trace") or {}
    s = (tr.get("spans") or {}).get(name)
    return s if s and s["device_s"] > 0 else None
