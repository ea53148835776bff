from repro_torch.utils.pytree import (
    PackedTree, flat_names, flat_update_dim, pack_leaves, tree_add_vector,
    tree_leaves, tree_map, unpack_leaves)
from repro_torch.utils.seeding import derived_seed

__all__ = ["PackedTree", "derived_seed", "flat_names", "flat_update_dim",
           "pack_leaves", "tree_add_vector", "tree_leaves", "tree_map",
           "unpack_leaves"]
