from repro_torch.utils.pytree import (
    flat_names, flat_update_dim, tree_add_vector, tree_leaves, tree_map)

__all__ = ["flat_names", "flat_update_dim", "tree_add_vector", "tree_leaves",
           "tree_map"]
