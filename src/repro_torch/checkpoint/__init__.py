"""Durable round state of the port (counterpart of ``repro.checkpoint``,
DESIGN.md §9): numpy-only ``.npz`` serialization keyed by the
reference's path strings, an atomic keep-N manager, and run manifests."""
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.checkpoint.manifest import (
    check_manifest, manifest_mismatches, run_manifest)
from repro_torch.checkpoint.serialization import (
    LeafSpec, load_pytree, params_tree, read_leaves, save_pytree)

__all__ = ["CheckpointManager", "LeafSpec", "check_manifest",
           "load_pytree", "manifest_mismatches", "params_tree",
           "read_leaves",
           "run_manifest", "save_pytree"]
