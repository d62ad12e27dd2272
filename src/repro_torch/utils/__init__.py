from repro_torch.utils.device import check_params_on, resolve_device
from repro_torch.utils.tree import (tree_flatten, tree_leaves, tree_map,
                                    tree_unflatten)
