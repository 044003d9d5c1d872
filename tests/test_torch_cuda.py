"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked `cuda` and skips on a host without a card.  The
file imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from smplifyx_torch.ops import lbs as tlbs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, V, J, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    W = torch.rand(V, J, device=dev, generator=gen)
    W = W / W.sum(-1, keepdim=True)
    A = torch.randn(B, J, 16, device=dev, generator=gen) * 0.3
    A[..., [0, 5, 10, 15]] += 1.0
    v = torch.randn(B, V, 3, device=dev, generator=gen) * 0.5
    return W, A, v


@pytest.mark.parametrize("B,V,J", [(128, 10475, 55), (3, 500, 55),
                                   (256, 220, 55), (5, 129, 24), (1, 1, 64)])
def test_lbs_kernel_matches_plain_version(card, B, V, J):
    W, A, v = _inputs(B, V, J, card, seed=B + V)
    before = tlbs.lbs_apply.launches
    Ak, vk = A.clone().requires_grad_(True), v.clone().requires_grad_(True)
    out = tlbs.lbs_apply(W, Ak, vk)
    gout = torch.randn_like(out)
    (out * gout).sum().backward()
    Ap, vp = A.clone().requires_grad_(True), v.clone().requires_grad_(True)
    ref = tlbs.lbs_reference(W, Ap, vp)
    (ref * gout).sum().backward()
    torch.cuda.synchronize()
    assert tlbs.lbs_apply.launches == before + 1
    # f32 sums over J in another order
    assert (out - ref).abs().max().item() <= 1e-5
    for got, want in ((Ak.grad, Ap.grad), (vk.grad, vp.grad)):
        scale = max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= 1e-4 * scale


def test_lbs_kernel_refuses_mixed_devices_and_wide_j(card):
    W, A, v = _inputs(2, 50, 55, card, seed=0)
    with pytest.raises(ValueError):
        tlbs.lbs_apply(W.cpu(), A, v)
    W, A, v = _inputs(2, 50, 65, card, seed=0)
    with pytest.raises(ValueError, match="J <= 64"):
        tlbs.lbs_apply(W, A, v)
