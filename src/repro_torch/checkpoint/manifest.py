"""Run manifests, the fingerprint that guards resume (counterpart of
``repro/checkpoint/manifest.py``, DESIGN.md §9).

A checkpoint directory carries a ``manifest.json`` written by its first
save: the ``FedConfig`` and ``TrainConfig`` field dicts, the
architecture and the reference's ``use_trust`` key. ``check_manifest``
refuses to resume a run whose manifest differs, naming every differing
field. ``rounds`` is
the run's length, not its identity, so it is left out: a 6-round
checkpoint resumed with ``--rounds 10`` trains on. Everything is
JSON round-tripped before comparison, so tuple-against-list artefacts
never make a false mismatch.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List

MANIFEST_VERSION = 1


def _jsonable(obj: Any) -> Any:
    """Normalise through a JSON round-trip (tuples -> lists, key order)."""
    return json.loads(json.dumps(obj, sort_keys=True, default=str))


def run_manifest(model_cfg, fed, train_cfg) -> Dict[str, Any]:
    """The resume-compatibility fingerprint of a federated run.

    ``model_cfg`` / ``fed`` / ``train_cfg`` are the frozen config
    dataclasses. Wall-clock, output paths, checkpoint cadence and
    ``fed.rounds`` deliberately do NOT enter the manifest — they may
    differ between the interrupted and the resuming invocation
    (``rounds`` is the run-length target, not run identity: resuming a
    6-round checkpoint with ``--rounds 10`` trains it longer, it does
    not continue a different experiment).
    """
    fed_dict = dataclasses.asdict(fed)
    fed_dict.pop("rounds", None)
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "arch": model_cfg.name,
        "family": model_cfg.family,
        "model": dataclasses.asdict(model_cfg),
        "fed": fed_dict,
        "train": dataclasses.asdict(train_cfg),
        # the reference's trainer-level trust switch, under its key; the
        # port turns trust on through aggregator_kwargs (in "fed") only
        "use_trust": False,
    }
    return _jsonable(manifest)


def manifest_mismatches(saved: Dict[str, Any], current: Dict[str, Any]
                        ) -> List[str]:
    """Dotted paths of every leaf where the two manifests disagree."""
    saved = _jsonable(saved)
    current = _jsonable(current)
    diffs: List[str] = []

    def walk(a: Any, b: Any, path: str) -> None:
        if isinstance(a, dict) and isinstance(b, dict):
            for k in sorted(set(a) | set(b)):
                walk(a.get(k), b.get(k), f"{path}.{k}" if path else str(k))
        elif a != b:
            diffs.append(f"{path}: saved={a!r} current={b!r}")

    walk(saved, current, "")
    return diffs


def check_manifest(saved: Dict[str, Any], current: Dict[str, Any]) -> None:
    """Refuse to resume a mismatched run (DESIGN.md §9).

    Raises ``ValueError`` listing every differing field; a checkpoint
    from a different config/arch must never silently continue.
    """
    diffs = manifest_mismatches(saved, current)
    if diffs:
        raise ValueError(
            "checkpoint manifest does not match this run — refusing to "
            "resume a different experiment:\n  " + "\n  ".join(diffs))
