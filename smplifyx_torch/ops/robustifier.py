"""Robust error functions: gmof, the Geman-McClure robustifier of the
reprojection data term (reference smplifyx/utils.py:84-95)."""

from __future__ import annotations

import torch


def gmof(residual: torch.Tensor, rho: float) -> torch.Tensor:
    """Geman-McClure: rho^2 * r^2 / (r^2 + rho^2), elementwise."""
    sq = residual * residual
    rho_sq = float(rho) ** 2
    return rho_sq * sq / (sq + rho_sq)
