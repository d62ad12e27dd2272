from repro_torch.utils.device import check_params_on, resolve_device
from repro_torch.utils.tree import (flat_size, leaf_offsets, leaf_paths,
                                    tree_concat_flat, tree_flatten,
                                    tree_from_flat, tree_leaves, tree_map,
                                    tree_unflatten, tree_zeros_like_flat)


def __getattr__(name):
    # the analyzer's walker imports this package: load it on first use
    if name == "max_square_dims":
        from repro_torch.analysis.walk import max_square_dims
        return max_square_dims
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
