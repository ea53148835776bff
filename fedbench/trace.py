"""Reduce a ``torch.profiler`` chrome trace of a traced stretch to what
the per-layer metrics read.

The stretch is the host range of the ``fedbench::window`` annotation.
Inside it:

* ``busy_s``: the union of the device's kernel, copy and set intervals;
* ``kernels``: each kernel name's device seconds and launches;
* ``spans``: for each ``fedbench::<step>`` annotation the harness put
  around a call into the program, and for each of the program's own ops
  named in ``ops`` (a ``torch.library`` op such as
  ``repro_torch::flash_attention``), the calls, and the device seconds
  and kernels of the work launched inside them (runtime and driver launch
  events matched to device events by their correlation id), so a kernel
  is attributed by the call that launched it, not by its symbol;
* ``gaps``: the device's idle intervals, each named by what the host was
  doing when it began (the innermost ``fedbench::`` span and host op).
"""
from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "fedbench::window"
SPAN = "fedbench::"


def _cat(ev) -> str:
    return str(ev.get("cat", "")).lower()


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def _innermost(events, starts, t: float) -> str:
    """The latest-starting event of ``events`` (sorted by start) that is
    open at ``t``, or ``""``."""
    i = bisect.bisect_right(starts, t)
    for ev in reversed(events[max(0, i - 4000):i]):
        if ev["ts"] + ev.get("dur", 0) > t:
            return ev["name"]
    return ""


def reduce(path: str, ops=(), top: int = 10) -> Dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    windows = [e for e in events if e["name"] == WINDOW
               and _cat(e) == "user_annotation"]
    if not windows:
        return {}
    win = windows[0]
    lo, hi = win["ts"], win["ts"] + win["dur"]
    host_tid = win["tid"]

    by_corr = collections.defaultdict(list)
    for e in events:
        if _cat(e) in DEVICE_CATS:
            by_corr[e.get("args", {}).get("correlation")].append(e)
    device = [e for e in events if _cat(e) in DEVICE_CATS
              and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    kernels = collections.defaultdict(lambda: [0.0, 0])
    for e in device:
        if _cat(e) == "kernel":
            k = kernels[e["name"][:200]]
            k[0] += e["dur"] * 1e-6
            k[1] += 1
    busy = _union([(max(lo, e["ts"]), min(hi, e["ts"] + e["dur"]))
                   for e in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6

    launches = sorted((e for e in events if _cat(e) in LAUNCH_CATS),
                      key=lambda e: e["ts"])
    launch_ts = [e["ts"] for e in launches]
    spans = collections.defaultdict(lambda: {"device_s": 0.0, "launches": 0,
                                             "calls": 0})
    for a in events:
        if not lo <= a["ts"] <= hi or a["name"] == WINDOW:
            continue
        if _cat(a) == "user_annotation" and a["name"].startswith(SPAN):
            s = spans[a["name"][len(SPAN):]]
        elif _cat(a) == "cpu_op" and a["name"] in ops:
            s = spans[a["name"]]
        else:
            continue
        s["calls"] += 1
        i = bisect.bisect_left(launch_ts, a["ts"])
        j = bisect.bisect_right(launch_ts, a["ts"] + a["dur"])
        for ev in launches[i:j]:
            if ev["tid"] != a["tid"]:
                continue
            for d in by_corr.get(ev.get("args", {}).get("correlation"), ()):
                if _cat(d) == "kernel":
                    s["device_s"] += d["dur"] * 1e-6
                    s["launches"] += 1

    host = sorted((e for e in events if e["tid"] == host_tid
                   and _cat(e) in ("cpu_op", "user_annotation")
                   and lo <= e["ts"] <= hi and e["name"] != WINDOW),
                  key=lambda e: e["ts"])
    marks = [e for e in host if e["name"].startswith(SPAN)]
    host_ops = [e for e in host if not e["name"].startswith(SPAN)]
    mark_ts, op_ts = [e["ts"] for e in marks], [e["ts"] for e in host_ops]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)
    named = collections.Counter()
    for dur, start in gaps[:500]:
        step = _innermost(marks, mark_ts, start)[len(SPAN):] or "between"
        named[f"{step}/{_innermost(host_ops, op_ts, start) or 'python'}"] += \
            dur * 1e-6
    return {
        "window_s": (hi - lo) * 1e-6,
        "busy_s": busy_s,
        "kernels": {k: {"device_s": v[0], "launches": v[1]}
                    for k, v in kernels.items()},
        "spans": dict(spans),
        "breakdown": {
            "device_ops": [[k, v[0]] for k, v in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:top]],
            "idle_gaps": [[k, v] for k, v in named.most_common(top)]},
    }
