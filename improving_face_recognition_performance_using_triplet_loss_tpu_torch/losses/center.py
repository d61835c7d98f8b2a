"""Center loss (Wen et al., ECCV 2016; facenet's ``center_loss``).

Port of the JAX package's ``losses/center.py``. The centers table is not
a parameter: the step passes it in and takes the updated table back, as
the JAX step threads it through its state.
"""

from __future__ import annotations

import torch


def center_loss(features: torch.Tensor, labels: torch.Tensor,
                centers: torch.Tensor, alfa: float = 0.95):
    """The loss ``mean((features - centers[labels])^2)`` and the updated
    table ``centers - (1 - alfa) * (centers[labels] - features)`` added at
    each label, duplicates accumulating. ``features`` [B, D], ``labels``
    [B], ``centers`` [num_classes, D]; the table carries no gradient.

    The update is ``index_add_``: on the card its atomics add duplicate
    labels' rows in no fixed order, so the table matches the JAX
    ``.at[].add`` to float32 rounding (a few ulps), not bit for bit."""
    idx = labels.long()
    centers_batch = centers.index_select(0, idx)
    diff = (1.0 - alfa) * (centers_batch - features.detach())
    new_centers = centers.index_add(0, idx, -diff)
    loss = torch.mean(torch.square(features - centers_batch))
    return loss, new_centers
