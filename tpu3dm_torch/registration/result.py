"""Registration result container (port of tpu3dm/registration/result.py).

Open3D's ``RegistrationResult`` fields (transformation, fitness, inlier_rmse)
plus the hypotheses or ICP iterations spent.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RegistrationResult:
    transformation: torch.Tensor  # [4, 4] float32, target <- source
    fitness: torch.Tensor  # scalar float32: inlier fraction
    inlier_rmse: torch.Tensor  # scalar float32: RMSE over inlier correspondences
    iterations: torch.Tensor  # scalar int: hypotheses or ICP iterations spent
