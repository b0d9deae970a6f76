"""Dense weights made from the seed, on the device, one draw per leaf.

Both sides take these: the program is handed them and prunes and packs
them itself; the reference makes them again from the same seed and
prunes them by its own copy of the rule.  The layout is the port's
parameter tree as the configuration's reference module gives it
(``leaf_shapes``; a decoder's block leaves stacked over the layers):
norms zero, the embedding and every projection N(0, 0.02²), the output
projections (``wo``, ``w_down``) N(0, (0.02/√(2L))²), in float32, the
type the configuration states for the parameters.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from harness.manifest import reference_module


def make_params(model: Dict, seed: int, device) -> Dict:
    """The dense parameter tree for ``seed``: one ``randn`` per leaf from
    a generator on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    depth = 0.02 / math.sqrt(2 * model["num_layers"])
    tree: Dict = {}
    for path, shape in reference_module(model).leaf_shapes(model):
        name = path[-1]
        if "norm" in name:
            leaf = torch.zeros(shape, device=device)
        else:
            leaf = torch.randn(shape, generator=gen, device=device)
            leaf.mul_(depth if name in ("wo", "w_down") else 0.02)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[name] = leaf
    return tree


def leaves(tree: Dict, path: Tuple[str, ...] = ()):
    """(path, leaf) of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree
