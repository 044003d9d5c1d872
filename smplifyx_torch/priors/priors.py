"""Pose/shape priors: max-of-Gaussians (GMM), L2 and the bending-angle prior.

Counterpart of `smplifyx_tpu/priors/priors.py` (reference
smplifyx/prior.py): the GMM is a dataclass of precomputed tensors and the
min over components is one batched einsum.
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass

import numpy as np
import torch

from smplifyx_torch.utils.device import resolve_device
from smplifyx_torch.utils.tensors import TensorFields

# Elbow/knee flexion indices into the FULL pose vector (with global orient).
ANGLE_PRIOR_IDXS_FULL = (55, 58, 12, 15)
ANGLE_PRIOR_SIGNS = (1.0, -1.0, -1.0, -1.0)


@dataclass
class GMMPrior(TensorFields):
    """Max-of-Gaussians negative log-likelihood prior."""

    means: torch.Tensor            # [K, D]
    precisions: torch.Tensor       # [K, D, D]
    weights: torch.Tensor          # [K]
    log_nll_weights: torch.Tensor  # [K] log(w_k / (const * sqrtdet_k / min))

    def __call__(self, pose: torch.Tensor) -> torch.Tensor:
        """pose [..., D] -> NLL [...] (min over components)."""
        diff = pose[..., None, :] - self.means
        quad = torch.einsum("...kd,kde,...ke->...k", diff, self.precisions, diff)
        return torch.min(0.5 * quad - self.log_nll_weights, dim=-1).values


def _gmm_from_arrays(means, covs, weights, device) -> GMMPrior:
    precisions = np.stack([np.linalg.inv(c) for c in covs])
    sqrdets = np.array([np.sqrt(np.linalg.det(c)) for c in covs])
    # Reference quirk kept for loss-level parity (prior.py:154): the
    # normalizer exponent is 69 whatever the mixture's dimension, a constant
    # offset with no gradient effect.
    const = (2 * np.pi) ** (69 / 2.0)
    nll_weights = weights / (const * (sqrdets / sqrdets.min()))
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return GMMPrior(means=t(means), precisions=t(precisions), weights=t(weights),
                    log_nll_weights=t(np.log(nll_weights)))


def load_gmm_pickle(path: str, device="cuda") -> GMMPrior:
    """Load a gmm_{K}.pkl artifact (dict or sklearn GMM).  Only for trusted
    artifacts: unpickling can run code."""
    with open(path, "rb") as f:
        gmm = pickle.load(f, encoding="latin1")
    if isinstance(gmm, dict):
        means, covs, weights = gmm["means"], gmm["covars"], gmm["weights"]
    else:
        means, covs, weights = gmm.means_, gmm.covars_, gmm.weights_
    return _gmm_from_arrays(np.asarray(means, np.float64),
                            np.asarray(covs, np.float64),
                            np.asarray(weights, np.float64), device)


def synthetic_gmm(num_components: int = 8, dim: int = 69, seed: int = 0,
                  device="cuda") -> GMMPrior:
    """Random well-conditioned mixture shaped like gmm_08.pkl, identical to
    the JAX package's for one seed."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=0.3, size=(num_components, dim))
    covs = []
    for _ in range(num_components):
        A = rng.normal(size=(dim, dim)) * 0.05
        covs.append(A @ A.T + np.eye(dim) * 0.1)
    weights = rng.dirichlet(np.ones(num_components))
    return _gmm_from_arrays(means, np.stack(covs), weights, device)


def l2_prior(x: torch.Tensor) -> torch.Tensor:
    """Sum of squares over all non-batch axes -> [B]."""
    return torch.sum(x * x, dim=tuple(range(1, x.dim())))


def angle_prior(pose: torch.Tensor, with_global_pose: bool = False) -> torch.Tensor:
    """Bending prior on elbows/knees: sum of exp(pose[idx] * sign)^2 -> [...]."""
    shift = 0 if with_global_pose else 3
    # Python-int picks: no index tensor is copied to the card per call.
    picked = torch.stack([pose[..., i - shift] * s for i, s in
                          zip(ANGLE_PRIOR_IDXS_FULL, ANGLE_PRIOR_SIGNS)], dim=-1)
    # Clamp the exponent so wild line-search probes cannot overflow f32.
    vals = torch.clamp(picked, -40.0, 40.0)
    return torch.sum(torch.exp(vals) ** 2, dim=-1)
