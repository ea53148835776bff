"""Round-state checkpoint manager (counterpart of
``repro/checkpoint/manager.py``), DESIGN.md §9:

* atomic saves: a checkpoint is written to a temporary file in the same
  directory and moved into place with ``os.replace``, so a crash or a
  kill mid-write never leaves a truncated ``ckpt_*.npz``;
* ``restore_with_step`` (and ``restore``, the tree alone) walks the
  steps newest-first and skips, with a warning, a checkpoint that fails
  to load into the template (torn, corrupt or foreign);
* ``save`` writes the run manifest (:mod:`.manifest`) beside the first
  checkpoint and refuses, on a later save, a manifest that differs from
  the one on disk; the trainer checks it before restoring;
* files that are not ``ckpt_<8 digits>.npz`` are ignored by ``steps``
  and the ``keep`` garbage collection.
"""
from __future__ import annotations

import glob
import json
import os
import re
import tempfile
import warnings
import zipfile
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.checkpoint.manifest import check_manifest
from repro_torch.checkpoint.serialization import (
    load_pytree, save_pytree)

_CKPT_RE = re.compile(r"ckpt_(\d+)\.npz$")
MANIFEST_NAME = "manifest.json"


class CheckpointManager:
    """Keeps the ``keep`` newest round-state checkpoints in a directory.

    ``save_every`` is the cadence policy of ``should_save`` and
    ``maybe_save``: the trainer asks ``should_save(step)`` after every
    round, so it copies the state to the host only for a save
    (``save_every <= 0`` disables periodic saves; ``save`` always
    writes). A state is a tree of numpy leaves
    (``FederatedTrainer.state_dict``).
    """

    def __init__(self, directory: str, keep: int = 3,
                 save_every: int = 0):
        self.directory = directory
        self.keep = int(keep)
        self.save_every = int(save_every)
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- paths
    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.npz")

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.directory, MANIFEST_NAME)

    def steps(self) -> List[int]:
        """Sorted steps of every well-named checkpoint in the directory.

        Non-matching files (``ckpt_tmp.npz``, partial tmp writes) are
        skipped — a stray file must never crash gc or resume.
        """
        steps = []
        for f in glob.glob(os.path.join(self.directory, "ckpt_*.npz")):
            m = _CKPT_RE.search(f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    # ------------------------------------------------------------- saves
    def _atomic_write(self, path: str, writer) -> None:
        """Write via tmp file + ``os.replace`` so readers (and crashes)
        never observe a partial file; the tmp name cannot collide with
        the ``ckpt_<digits>.npz`` pattern ``steps()`` recognises."""
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix="tmp_",
                                   suffix=".part")
        try:
            with os.fdopen(fd, "wb") as f:
                writer(f)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def save(self, step: int, state: Any,
             manifest: Optional[Dict[str, Any]] = None) -> str:
        """Atomically write ``state`` as step ``step``, then gc to the
        ``keep`` newest. ``manifest`` is written when the directory has
        none; one that differs from the directory's raises
        ``ValueError`` before anything is written, so a directory never
        mixes two runs."""
        if manifest is not None:
            saved = self.read_manifest()
            if saved is None:
                self.write_manifest(manifest)
            else:
                check_manifest(saved, manifest)
        path = self._path(int(step))
        self._atomic_write(path, lambda f: save_pytree(state, f))
        self._gc()
        return path

    def should_save(self, step: int) -> bool:
        """The ``save_every`` cadence policy (step 0 never saves —
        nothing has happened yet)."""
        return (self.save_every > 0 and step > 0
                and step % self.save_every == 0)

    def maybe_save(self, step: int, state: Any,
                   manifest: Optional[Dict[str, Any]] = None
                   ) -> Optional[str]:
        """:meth:`save` if the cadence policy asks for ``step``, else
        ``None``."""
        if not self.should_save(step):
            return None
        return self.save(step, state, manifest=manifest)

    # ---------------------------------------------------------- manifest
    def write_manifest(self, manifest: Dict[str, Any]) -> str:
        payload = json.dumps(manifest, indent=1, sort_keys=True)
        self._atomic_write(self.manifest_path,
                           lambda f: f.write(payload.encode()))
        return self.manifest_path

    def read_manifest(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.manifest_path):
            return None
        with open(self.manifest_path) as f:
            return json.load(f)

    # ------------------------------------------------------------ restore
    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """The tree of :meth:`restore_with_step`, without its step."""
        return self.restore_with_step(template, step)[0]

    def restore_with_step(self, template: Any,
                          step: Optional[int] = None) -> Tuple[Any, int]:
        """``(tree, step)`` of the newest checkpoint that loads into
        ``template`` (or of exactly ``step``); a checkpoint that fails to
        load is skipped with a warning. ``FileNotFoundError`` when none
        loads."""
        return self.load_newest(lambda path: load_pytree(template, path),
                                step)

    def load_newest(self, load: Callable[[str], Any],
                    step: Optional[int] = None) -> Tuple[Any, int]:
        """``(load(path), step)`` of the newest checkpoint ``load`` reads
        without an error (or of exactly ``step``), skipping, with a
        warning, one it fails on. ``FileNotFoundError`` when none
        loads."""
        if step is not None:
            candidates = [int(step)]
        else:
            candidates = list(reversed(self.steps()))
        if not candidates:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        errors = []
        for s in candidates:
            path = self._path(s)
            try:
                return load(path), s
            except (OSError, EOFError, KeyError, ValueError,
                    zipfile.BadZipFile) as e:   # torn, foreign, other run
                errors.append(f"{os.path.basename(path)}: {e}")
                warnings.warn(
                    f"skipping corrupt checkpoint {path}: {e}",
                    RuntimeWarning, stacklevel=2)
        raise FileNotFoundError(
            f"no restorable checkpoint in {self.directory} "
            f"(tried {len(candidates)}):\n  " + "\n  ".join(errors))

    # ----------------------------------------------------------------- gc
    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            os.remove(self._path(s))
