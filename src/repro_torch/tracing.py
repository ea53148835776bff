"""Spans and counters of the port's own layers.

``span(name)`` marks a stretch of the program (a round, one of its
steps, a local step's gradient), ``count(name, n)`` adds to a counter,
``enable(on)`` switches recording on or off, and ``export()`` hands over
what was recorded and clears it.

* **Off** (the default) a span costs a flag check and one
  ``torch.autograd._profiler_enabled()`` call and returns a shared null
  context: nothing is allocated, recorded, captured or synchronised, and
  ``count`` does nothing.
* **Under an active ``torch.profiler``**, on or off, a span opens
  ``record_function("repro_torch.<name>")``, so the spans land in the
  profiler's trace beside the device's kernels, on its clock. The dot
  keeps them apart from the kernel ops' ``repro_torch::`` namespace.
* **On**, each span also keeps its name, id, parent's id, round, its host
  start and end (``time.perf_counter_ns``) and, once CUDA is in use, a
  start and an end ``torch.cuda.Event`` on the current stream: the
  stream's time from the span's first launch to its last, gaps included.
  At most ``MAX_SPANS`` are kept; the rest count as ``tracing.dropped``.

**Graphs.** A span opened while the current stream is being captured,
inside :func:`graph_spans`, records its events as nodes of the graph
(``external=True``), and the records go to the list that
:func:`graph_spans` yields, not to the store. After a replay of that
graph, :func:`replayed` queues a copy of them under the current span
(the ``replay``); :func:`settle` reads the copy's device times once the
replay has finished, before the next replay overwrites its events, and
never waits for it: a replay not finished by then counts as
``tracing.unread``. A graph captured with tracing off holds no event
node. A span opened in a capture outside :func:`graph_spans` records
nothing.

Spans open and close on the thread that runs the round; a round's
``local_train`` runs its Python once under ``vmap``, so its step spans
open once a round, not once a client.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, Iterator, List, Optional

import torch

PREFIX = "repro_torch."
MAX_SPANS = 65536
_NULL = contextlib.nullcontext()


class _Record:
    """One span: host times in ns, and the CUDA events (or ``None``)."""

    __slots__ = ("name", "id", "parent", "round", "t0", "t1", "start",
                 "end", "device_ms", "replay")

    def __init__(self, name: str, id_: int, parent: Optional[int],
                 round_idx: Optional[int]):
        self.name, self.id, self.parent, self.round = (name, id_, parent,
                                                       round_idx)
        self.t0 = self.t1 = None
        self.start = self.end = None
        self.device_ms = None
        self.replay = False

    def row(self) -> dict:
        host = (None if self.t0 is None or self.t1 is None
                else (self.t1 - self.t0) * 1e-6)
        return {"name": self.name, "id": self.id, "parent": self.parent,
                "round": self.round, "host_start_ns": self.t0,
                "host_end_ns": self.t1, "host_ms": host,
                "device_ms": self.device_ms, "replay": self.replay}


class Tracer:
    """The store behind the module's functions: the kept spans, the
    counters, the open spans and the replays whose times are not yet
    read."""

    def __init__(self):
        self.on = False
        self.limit = MAX_SPANS
        self.spans: List[_Record] = []
        self.counters: Dict[str, int] = collections.Counter()
        self.stack: List[_Record] = []
        self.next_id = 0
        self.graph: Optional[List[_Record]] = None
        self.pending: List[tuple] = []

    # ------------------------------------------------------------ spans
    def open(self, name: str, round_idx) -> Optional[_Record]:
        capturing = (torch.cuda.is_initialized()
                     and torch.cuda.is_current_stream_capturing())
        if capturing and self.graph is None:
            return None
        parent = self.stack[-1] if self.stack else None
        if round_idx is None and parent is not None:
            round_idx = parent.round
        rec = _Record(name, self.next_id, None if parent is None
                      else parent.id, round_idx)
        self.next_id += 1
        if torch.cuda.is_initialized():
            rec.start = torch.cuda.Event(enable_timing=True,
                                         external=capturing)
            rec.start.record()
        rec.t0 = time.perf_counter_ns()
        self.stack.append(rec)
        return rec

    def close(self, rec: _Record) -> None:
        rec.t1 = time.perf_counter_ns()
        capturing = (rec.start is not None
                     and torch.cuda.is_current_stream_capturing())
        if rec.start is not None:
            rec.end = torch.cuda.Event(enable_timing=True,
                                       external=capturing)
            rec.end.record()
        self.stack.remove(rec)
        if capturing:
            self.graph.append(rec)
        else:
            self.keep(rec)

    def keep(self, rec: _Record) -> None:
        if len(self.spans) < self.limit:
            self.spans.append(rec)
        else:
            self.counters["tracing.dropped"] += 1

    # ----------------------------------------------------------- replays
    def replayed(self, records: List[_Record]) -> None:
        if not self.on or not records:
            return
        parent = self.stack[-1] if self.stack else None
        self.pending.append((records, parent))

    def settle(self) -> None:
        for records, parent in self.pending:
            if not all(r.end.query() for r in records):
                self.counters["tracing.unread"] += len(records)
                continue
            ids = {}
            for r in sorted(records, key=lambda r: r.id):
                copy = _Record(r.name, self.next_id, ids.get(r.parent),
                               None if parent is None else parent.round)
                if copy.parent is None and parent is not None:
                    copy.parent = parent.id
                ids[r.id] = copy.id
                self.next_id += 1
                copy.device_ms = r.start.elapsed_time(r.end)
                copy.replay = True
                self.keep(copy)
        self.pending.clear()

    # ------------------------------------------------------------ export
    def export(self) -> dict:
        if self.pending or any(r.start is not None for r in self.spans):
            torch.cuda.synchronize()
        self.settle()
        rows = []
        for r in sorted(self.spans, key=lambda r: r.id):
            if r.start is not None:
                r.device_ms = r.start.elapsed_time(r.end)
            rows.append(r.row())
        out = {"spans": rows, "counters": dict(self.counters)}
        self.spans.clear()
        self.counters.clear()
        return out


_TRACER = Tracer()


class _Span:
    """The context a span opens when the profiler or tracing is on."""

    __slots__ = ("name", "round", "rf", "rec")

    def __init__(self, name: str, round_idx):
        self.name, self.round = name, round_idx
        self.rf = self.rec = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        if _TRACER.on:
            self.rec = _TRACER.open(self.name, self.round)
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            _TRACER.close(self.rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, round_idx: Optional[int] = None):
    """A context around one stretch of the program. ``round_idx`` names
    the round it belongs to; without it a span takes its parent's."""
    if not _TRACER.on and not torch.autograd._profiler_enabled():
        return _NULL
    return _Span(name, round_idx)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _TRACER.on:
        _TRACER.counters[name] += n


def enable(on: bool = True) -> None:
    """Switch recording on or off; what was recorded stays until
    :func:`export`."""
    _TRACER.on = bool(on)


def enabled() -> bool:
    return _TRACER.on


@contextlib.contextmanager
def graph_spans() -> Iterator[List[_Record]]:
    """Around a CUDA graph's capture: yields the list that collects the
    records of the spans opened in it (empty while tracing is off)."""
    out: List[_Record] = []
    before, _TRACER.graph = _TRACER.graph, out
    try:
        yield out
    finally:
        _TRACER.graph = before


def replayed(records: List[_Record]) -> None:
    """After a replay of the graph whose spans are ``records``: queue a
    copy of them, under the open span and in its round, to be read by
    :func:`settle`. Call it for the replay whose times are wanted; a
    later replay overwrites them."""
    _TRACER.replayed(records)


def settle() -> None:
    """Read the queued replays' device times where the device has
    finished them; adds no synchronisation."""
    if _TRACER.pending:
        _TRACER.settle()


def export() -> Dict[str, object]:
    """Synchronise once, read every kept span's times and return
    ``{"spans": [...], "counters": {...}}`` (spans in the order they
    opened, each ``name``, ``id``, ``parent``, ``round``,
    ``host_start_ns``, ``host_end_ns``, ``host_ms``, ``device_ms`` and
    ``replay``, true for a graph replay's copy, which has no host times;
    a span on the CPU has no device time);
    then clear the store and the counters."""
    return _TRACER.export()
