"""Inducing-point interpolation (counterpart of control_toolkit_tpu/ops/interpolation.py).

``interpolation_matrix`` is the JAX package's numpy function unchanged,
so the ``[P, H]`` weights are bit-equal; ``Interpolator.interpolate``
applies them with one ``torch.einsum``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch


def num_inducing_points(horizon: int, period: int) -> int:
    """``ceil((H-1)/p) + 1``: the first point at step 0, points ``p`` apart."""
    return int(math.ceil((horizon - 1) / period)) + 1


def interpolation_matrix(horizon: int, period: int) -> np.ndarray:
    """The ``[P, H]`` linear-interpolation matrix: step h lies between
    inducing points ``h // period`` and ``h // period + 1`` with fractional
    position ``(h % period) / period``."""
    p_count = num_inducing_points(horizon, period)
    mat = np.zeros((p_count, horizon), dtype=np.float32)
    for h in range(horizon):
        left = h // period
        frac = (h % period) / period
        if left + 1 < p_count:
            mat[left, h] = 1.0 - frac
            mat[left + 1, h] = frac
        else:
            mat[left, h] = 1.0
    return mat


@dataclass(frozen=True)
class Interpolator:
    """Precomputed inducing-point upsampler ``[..., P, U] -> [..., H, U]``
    (the identity for ``period == 1``)."""

    horizon: int
    period: int
    matrix: torch.Tensor = field(repr=False)  # [P, H]

    @classmethod
    def build(cls, horizon: int, period: int, device: torch.device) -> "Interpolator":
        if period < 1:
            raise ValueError("period_interpolation_inducing_points must be >= 1")
        mat = torch.as_tensor(interpolation_matrix(horizon, period), device=device)
        return cls(horizon=horizon, period=period, matrix=mat)

    @property
    def number_of_interpolation_inducing_points(self) -> int:
        return self.matrix.shape[0]

    def interpolate(self, y: torch.Tensor) -> torch.Tensor:
        """``[..., P, U] -> [..., H, U]``, contiguous: the einsum lays out
        U > 1 controls input-major, and the kernels take contiguous
        operands only."""
        if self.period == 1:
            return y
        return torch.einsum("...pu,ph->...hu", y, self.matrix).contiguous()
