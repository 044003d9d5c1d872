"""VPoser v1 (the SMPLify-X pose VAE) as torch modules.

Counterpart of `smplifyx_tpu/models/vposer.py` (reference: the external
`human_body_prior` package; latent-space body-pose optimisation decodes
z -> 21-joint axis-angle in every energy evaluation, smplifyx/fitting.py:
236-238, and the latent starts from the encoded regression-prior pose,
fit_single_frame.py:241-249).

    encoder:  BN(63) -> leaky_relu(fc 63->512) -> BN(512) ->
              leaky_relu(fc 512->512) -> (mu, softplus(logvar)) heads (32)
    decoder:  leaky_relu(fc 32->512) -> leaky_relu(fc 512->512) ->
              fc 512->21*6 -> continuous 6D -> rotation matrices -> axis-angle

Inference only: BatchNorm reads its running statistics (eps 1e-5), there is
no dropout, and the weights take no gradient; the fit differentiates
`decode` with respect to z.  The submodules carry the human_body_prior v1
state_dict names, so a v1 checkpoint loads straight into them
(`load_vposer`).

While the span recorder records (`utils/timing.py`), each decode is a
`vposer` span with the rows it decodes (`lanes`) and whether autograd
records it (`grad`: grad mode on and z taking a gradient), autograd's
pass back through a recorded decode a `vposer` span with `backward=True`,
and each `encode_mean` one with `encode=True`.

`random_params(seed)` draws a v1 state_dict from a `torch.Generator`.  It
is not the JAX package's `random_params(seed)`, which draws from JAX's
PRNG: the two packages' "synthetic" VPosers differ.  To run both on one
network, pass one state_dict file to both `load_vposer`s, or the JAX
parameters through `convert.vposer`.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from smplifyx_torch.ops.rotation import rotmat_to_aa
from smplifyx_torch.utils import timing
from smplifyx_torch.utils.device import resolve_device
from smplifyx_torch.utils.graphs import segment

LATENT_DIM = 32
NUM_NEURONS = 512
NUM_JOINTS = 21
POSE_DIM = NUM_JOINTS * 3
SLOPE = 0.2         # leaky_relu slope of VPoser v1 (torch's default is 0.01)
BN_EPS = 1e-5

# name -> (in, out) of every Linear, in the v1 state_dict's names
_LINEARS = {
    "bodyprior_enc_fc1": (POSE_DIM, NUM_NEURONS),
    "bodyprior_enc_fc2": (NUM_NEURONS, NUM_NEURONS),
    "bodyprior_enc_mu": (NUM_NEURONS, LATENT_DIM),
    "bodyprior_enc_logvar": (NUM_NEURONS, LATENT_DIM),
    "bodyprior_dec_fc1": (LATENT_DIM, NUM_NEURONS),
    "bodyprior_dec_fc2": (NUM_NEURONS, NUM_NEURONS),
    "bodyprior_dec_out": (NUM_NEURONS, NUM_JOINTS * 6),
}
_BATCHNORMS = {"bodyprior_enc_bn1": POSE_DIM, "bodyprior_enc_bn2": NUM_NEURONS}


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.leaky_relu's form: at x = 0 the slope is 1, where torch's
    F.leaky_relu takes SLOPE (a zero latent through zero biases lands on
    it)."""
    return torch.where(x >= 0, x, SLOPE * x)


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation representation [..., 6] -> [..., 3, 3] (Zhou
    et al.; the reference's ContinousRotReprDecoder).  The norms keep the
    eps inside the square root, so the gradient stays finite at a zero
    column (a clipped norm's is 0/0)."""
    x = x.reshape(*x.shape[:-1], 3, 2)
    a1, a2 = x[..., 0], x[..., 1]

    def normalize(v):
        return v * torch.rsqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-12)

    b1 = normalize(a1)
    b2 = normalize(a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


class VPoser(nn.Module):
    """VPoser v1 encoder and decoder in inference mode."""

    def __init__(self):
        super().__init__()
        for name, (n_in, n_out) in _LINEARS.items():
            setattr(self, name, nn.Linear(n_in, n_out))
        for name, n in _BATCHNORMS.items():
            setattr(self, name, nn.BatchNorm1d(n, eps=BN_EPS))
        self.eval()
        self.requires_grad_(False)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [..., 32] -> axis-angle body pose [..., 63]."""
        flat = z.reshape(-1, LATENT_DIM)
        lanes = flat.shape[0]
        with timing.span("vposer", lanes=lanes, grad=torch.is_grad_enabled()
                         and z.requires_grad) as sp:
            aa = segment("vposer", self._decode_rows, flat)
            if sp is not None:
                timing.backward_span("vposer", aa, flat, lanes=lanes,
                                     backward=True)
        return aa.reshape(*z.shape[:-1], POSE_DIM)

    def _decode_rows(self, flat: torch.Tensor) -> torch.Tensor:
        """[N, 32] -> [N, 21, 3]: the decoder's layers, one stretch of an
        evaluation (utils/graphs.py)."""
        x = leaky_relu(self.bodyprior_dec_fc1(flat))
        x = leaky_relu(self.bodyprior_dec_fc2(x))
        x = self.bodyprior_dec_out(x)
        return rotmat_to_aa(rot6d_to_rotmat(x.reshape(-1, NUM_JOINTS, 6)))

    def encode(self, pose: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """pose [..., 63] -> (mu, sigma) [..., 32]."""
        x = pose.reshape(-1, POSE_DIM)
        x = self.bodyprior_enc_bn1(x)
        x = leaky_relu(self.bodyprior_enc_fc1(x))
        x = self.bodyprior_enc_bn2(x)
        x = leaky_relu(self.bodyprior_enc_fc2(x))
        mu = self.bodyprior_enc_mu(x)
        sigma = F.softplus(self.bodyprior_enc_logvar(x))
        shape = (*pose.shape[:-1], LATENT_DIM)
        return mu.reshape(shape), sigma.reshape(shape)

    def encode_mean(self, pose: torch.Tensor) -> torch.Tensor:
        with timing.span("vposer", lanes=pose.numel() // POSE_DIM,
                         encode=True):
            return self.encode(pose)[0]


def vposer_from_state_dict(state_dict: dict, device="cuda") -> VPoser:
    """VPoser with a human_body_prior v1 state_dict's weights (tensors or
    numpy arrays; BatchNorm's `num_batches_tracked` may be absent)."""
    model = VPoser()
    own = model.state_dict()
    missing = [k for k in own if k not in state_dict
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"VPoser state_dict lacks {missing}")
    model.load_state_dict(
        {k: torch.tensor(np.asarray(state_dict[k])) if k in state_dict
         else own[k] for k in own})
    return model.to(resolve_device(device))


def load_vposer(ckpt_path: str, device="cuda") -> VPoser:
    """Load a human_body_prior v1 snapshot (a state_dict, a module, or a
    dict holding one under "state_dict").  Only for trusted files:
    unpickling can run code."""
    sd = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return vposer_from_state_dict(sd, device)


def random_params(seed: int = 0) -> dict:
    """A random v1 state_dict drawn from `torch.Generator().manual_seed(
    seed)`: Linear weights and biases uniform in +-1/sqrt(fan_in) (torch's
    default init), BatchNorm at identity statistics, except the output
    layer's bias: the 6D form of the identity, so that, like a trained
    VPoser, the decoder maps latents near 0 to poses near the rest pose
    (with torch's init alone every joint turns by a random large angle at
    any z)."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, (n_in, n_out) in _LINEARS.items():
        bound = 1.0 / math.sqrt(n_in)
        for key, shape in (("weight", (n_out, n_in)), ("bias", (n_out,))):
            sd[f"{name}.{key}"] = (torch.rand(shape, generator=gen) * 2.0
                                   - 1.0) * bound
    sd["bodyprior_dec_out.bias"] = torch.tensor(
        [1.0, 0.0, 0.0, 1.0, 0.0, 0.0]).repeat(NUM_JOINTS)
    for name, n in _BATCHNORMS.items():
        sd[f"{name}.weight"] = torch.ones(n)
        sd[f"{name}.bias"] = torch.zeros(n)
        sd[f"{name}.running_mean"] = torch.zeros(n)
        sd[f"{name}.running_var"] = torch.ones(n)
    return sd
