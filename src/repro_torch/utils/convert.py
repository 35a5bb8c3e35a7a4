"""numpy <-> torch conversion of whole pytrees.

Containers (dicts, tuples, NamedTuples such as an optimizer's ``SgdState``)
are kept as they are; only the leaves change type. dtypes carry over, so an
int32 step counter stays int32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.tree import tree_map


def tree_from_numpy(tree, device):
    """Every array leaf (numpy array, numpy scalar or tensor) as a tensor on
    ``device``; numpy leaves are copied, never shared."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                    else torch.tensor(np.asarray(x), device=device), tree)


def tree_to_numpy(tree):
    """Every tensor leaf as a host numpy array."""
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if isinstance(x, torch.Tensor) else np.asarray(x), tree)
