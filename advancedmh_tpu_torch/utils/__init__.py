from .keys import as_key, fold_in, generator, splitmix64, step_generator
from .tree import flatten_up_to, tree_flatten, tree_flatten_with_path, tree_map

__all__ = [
    "as_key", "fold_in", "generator", "splitmix64", "step_generator",
    "flatten_up_to", "tree_flatten", "tree_flatten_with_path", "tree_map",
]
