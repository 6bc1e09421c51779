"""Unstructured L1 pruning (paper Algorithm 1, step 2).

The accelerator natively supports pruned models: MEM_S&N only stores rows for
surviving connections, so pruning directly shrinks the event-dispatch work and
weight memory.  Per-layer unstructured magnitude (L1) pruning as masks,
matching torch.nn.utils.prune.l1_unstructured semantics.  Every function
takes torch tensors or numpy arrays and answers in the same kind.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.pytree import is_float_matrix, tree_leaves, tree_map


def l1_prune_mask(w, amount: float):
    """Mask keeping the (1-amount) largest-|w| entries. amount in [0,1).

    With ``k = round(amount * w.size)``, the threshold is the k-th smallest
    ``|w|`` and the mask keeps ``|w| > threshold``: entries tied with the
    threshold all go.  ``amount <= 0`` keeps all, ``k >= size`` keeps none.
    """
    is_t = isinstance(w, torch.Tensor)
    size = w.numel() if is_t else np.size(w)
    k = int(round(amount * size)) if amount > 0.0 else 0
    if k <= 0 or k >= size:
        keep = k <= 0
        if is_t:
            return torch.full(w.shape, keep, dtype=torch.bool, device=w.device)
        return np.full(np.shape(w), keep, dtype=bool)
    if is_t:
        mag = w.abs()
        return mag > torch.kthvalue(mag.reshape(-1), k).values
    mag = np.abs(np.asarray(w))
    return mag > np.partition(mag.reshape(-1), k - 1)[k - 1]


def prune_pytree(params, amount: float):
    """Per-layer L1-prune every >=2-D float leaf. Returns (pruned, masks);
    a leaf left alone has mask ``None``."""
    masks = tree_map(lambda w: l1_prune_mask(w, amount)
                     if is_float_matrix(w) else None, params)
    pruned = tree_map(lambda w, m: w if m is None else w * m, params, masks)
    return pruned, masks


def sparsity(params) -> float:
    """Fraction of zero entries over all >=2-D leaves."""
    zeros, total = 0, 0
    for leaf in tree_leaves(params):
        if hasattr(leaf, "ndim") and leaf.ndim >= 2:
            zeros += int((leaf == 0).sum())
            total += leaf.numel() if isinstance(leaf, torch.Tensor) \
                else leaf.size
    return zeros / max(total, 1)
