from repro_torch.utils.pytree import flat_names, tree_leaves, tree_map

__all__ = ["flat_names", "tree_leaves", "tree_map"]
