from repro_torch.utils.pytree import (
    PackedTree, flat_names, flat_update_dim, pack_leaves, tree_add,
    tree_add_vector, tree_bytes, tree_cast, tree_l2_norm, tree_leaves,
    tree_map, tree_scale, tree_size, tree_weighted_sum, tree_zeros_like,
    unpack_leaves)
from repro_torch.utils.seeding import derived_seed

__all__ = ["PackedTree", "derived_seed", "flat_names", "flat_update_dim",
           "pack_leaves", "tree_add", "tree_add_vector", "tree_bytes",
           "tree_cast", "tree_l2_norm", "tree_leaves", "tree_map",
           "tree_scale", "tree_size", "tree_weighted_sum",
           "tree_zeros_like", "unpack_leaves"]
