from repro_torch.utils.pytree import (
    flat_names, flat_update_dim, tree_add_vector, tree_leaves, tree_map)
from repro_torch.utils.seeding import derived_seed

__all__ = ["derived_seed", "flat_names", "flat_update_dim", "tree_add_vector",
           "tree_leaves", "tree_map"]
