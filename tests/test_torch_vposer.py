"""Port parity for VPoser v1 against the JAX package, on the CPU.

The two packages' "synthetic" VPosers are drawn by different generators,
so every comparison runs one network in both: the JAX package's random
parameters through `convert.vposer`, or one v1 state_dict file read by
both `load_vposer`s."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.models import vposer as jv
from smplifyx_tpu.ops.rotation import rotmat_to_aa as j_rotmat_to_aa

from smplifyx_torch import convert
from smplifyx_torch.models import vposer as tv
from smplifyx_torch.ops.rotation import batch_rodrigues, rotmat_to_aa
from smplifyx_torch.problem import slice_config
from smplifyx_torch.session import build_fit_session

VALUE_TOL = 1e-5
GRAD_RTOL = 1e-4


def _state_dict(seed=3):
    """A v1 state_dict with random BatchNorm statistics and affine terms."""
    sd = tv.random_params(seed)
    gen = torch.Generator().manual_seed(seed + 1)
    for name in ("bodyprior_enc_bn1", "bodyprior_enc_bn2"):
        n = sd[f"{name}.weight"].shape[0]
        sd[f"{name}.weight"] = 1.0 + 0.2 * torch.randn(n, generator=gen)
        sd[f"{name}.bias"] = 0.1 * torch.randn(n, generator=gen)
        sd[f"{name}.running_mean"] = 0.2 * torch.randn(n, generator=gen)
        sd[f"{name}.running_var"] = 0.5 + torch.rand(n, generator=gen)
    return sd


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """One state_dict file read by both packages' load_vposer."""
    path = tmp_path_factory.mktemp("vposer") / "vposer.pt"
    torch.save(_state_dict(), path)
    return jv.load_vposer(str(path)), tv.load_vposer(str(path), device="cpu")


@pytest.fixture(scope="module")
def converted():
    """The JAX package's random parameters, carried across by convert."""
    params = jv.random_params(0)
    return jv.VPoser(params), convert.vposer(
        jax.tree_util.tree_map(np.asarray, params), device="cpu")


def _latents(kind, n=3):
    if kind == "zero":
        return np.zeros((n, tv.LATENT_DIM), np.float32)
    return np.random.default_rng(7).normal(size=(n, tv.LATENT_DIM)).astype(np.float32)


def _poses(n=4):
    return np.random.default_rng(8).normal(0, 0.3, (n, tv.POSE_DIM)).astype(np.float32)


@pytest.mark.parametrize("nets", ["shared", "converted"])
def test_decode_and_encode_match_jax(nets, request):
    """decode at z = 0 and at random z (on the converted network: at z = 0
    and its products before the 6D map, see below), encode, encode_mean."""
    jnet, tnet = request.getfixturevalue(nets)
    for kind in ("zero", "random") if nets == "shared" else ("zero",):
        z = _latents(kind)
        np.testing.assert_allclose(
            tnet.decode(torch.as_tensor(z)).numpy(),
            np.asarray(jnet.decode(jnp.asarray(z))), rtol=0, atol=VALUE_TOL)
    pose = _poses()
    mu, sigma = tnet.encode(torch.as_tensor(pose))
    jmu, jsigma = jnet.encode(jnp.asarray(pose))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=0, atol=VALUE_TOL)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=0,
                               atol=VALUE_TOL)
    np.testing.assert_allclose(tnet.encode_mean(torch.as_tensor(pose)).numpy(),
                               np.asarray(jnet.encode_mean(jnp.asarray(pose))),
                               rtol=0, atol=VALUE_TOL)


def test_converted_decoder_products_match_jax(converted):
    """The JAX package's random network turns joints by random angles, and
    some of its 6D columns are short, so f32 rounding of the products moves
    its decoded poses by more than VALUE_TOL in both packages alike.  The
    weights carried across (kernel transposed, biases, slope 0.2) are held
    on the products themselves, the decoder's three layers as flax's
    Dense and jax.nn.leaky_relu define them."""
    jnet, tnet = converted
    z = _latents("random")
    p = jnet.params["decoder"]

    def dense(x, name):
        return x @ p[name]["kernel"] + p[name]["bias"]

    x = jax.nn.leaky_relu(dense(jnp.asarray(z), "fc1"), 0.2)
    want = dense(jax.nn.leaky_relu(dense(x, "fc2"), 0.2), "out")
    t = tv.leaky_relu(tnet.bodyprior_dec_fc1(torch.as_tensor(z)))
    got = tnet.bodyprior_dec_out(tv.leaky_relu(tnet.bodyprior_dec_fc2(t)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=VALUE_TOL)


@pytest.mark.parametrize("nets", ["shared", "converted"])
@pytest.mark.parametrize("kind", ["random", "zero"])
def test_decode_gradients_match_jax(nets, kind, request):
    jnet, tnet = request.getfixturevalue(nets)
    z = _latents(kind)
    w = np.random.default_rng(9).normal(size=(z.shape[0], tv.POSE_DIM)).astype(np.float32)
    want = np.asarray(jax.grad(
        lambda zz: jnp.sum(jnp.sin(jnet.decode(zz)) * w))(jnp.asarray(z)))
    zt = torch.tensor(z, requires_grad=True)
    (torch.sin(tnet.decode(zt)) * torch.as_tensor(w)).sum().backward()
    got = zt.grad.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= GRAD_RTOL * np.abs(want).max()


def test_rotmat_to_aa_gradient_is_finite_where_a_diagonal_entry_is_minus_one():
    """Rotations by pi about an axis, and by a right angle: the near-pi
    branch's root of (diag + 1) / 2 meets 0.  Values stay the JAX
    package's."""
    aa = torch.tensor([[0.0, 0.0, math.pi], [math.pi, 0.0, 0.0],
                       [0.0, math.pi / 2, 0.0], [0.3, -0.2, 0.1]])
    R = batch_rodrigues(aa)
    R[:2] = torch.diag_embed(torch.tensor([[-1.0, -1.0, 1.0], [1.0, -1.0, -1.0]]))
    R = R.detach().requires_grad_(True)
    out = rotmat_to_aa(R)
    (out * torch.arange(1.0, 4.0)).sum().backward()
    assert torch.isfinite(R.grad).all()
    np.testing.assert_allclose(
        out.detach().numpy(), np.asarray(j_rotmat_to_aa(jnp.asarray(R.detach().numpy()))),
        rtol=0, atol=1e-6)


def test_random_params_decode_near_the_rest_pose():
    net = tv.vposer_from_state_dict(tv.random_params(0), device="cpu")
    rest = net.decode(torch.zeros(1, tv.LATENT_DIM))
    spread = net.decode(torch.randn(256, tv.LATENT_DIM,
                                    generator=torch.Generator().manual_seed(0)))
    assert rest.abs().max() < 0.2
    assert 0.02 < spread.std(0).mean() < 0.3
    assert not any(p.requires_grad for p in net.parameters())
    assert not net.training


def test_load_vposer_reads_the_snapshot_forms(tmp_path):
    sd = _state_dict(5)
    z = torch.as_tensor(_latents("random"))
    want = tv.vposer_from_state_dict(sd, device="cpu").decode(z)
    module = tv.vposer_from_state_dict(sd, device="cpu")
    for i, obj in enumerate([sd, {"state_dict": sd}, module]):
        path = tmp_path / f"snap{i}.pt"
        torch.save(obj, path)
        assert torch.equal(tv.load_vposer(str(path), device="cpu").decode(z), want)
    with pytest.raises(KeyError, match="bodyprior_dec_out.bias"):
        tv.vposer_from_state_dict(
            {k: v for k, v in sd.items() if k != "bodyprior_dec_out.bias"},
            device="cpu")


def test_session_wires_vposer(tmp_path):
    path = tmp_path / "vposer.pt"
    torch.save(_state_dict(), path)
    for ckpt in ("", "synthetic", str(path)):
        cfg = slice_config(96, use_vposer=True, vposer_ckpt=ckpt,
                           interpenetration=False)
        session = build_fit_session(cfg, device="cpu")
        assert session.vposer is not None
        assert session.settings.use_vposer and session.settings.body_dim == 32
        z = torch.as_tensor(_latents("random"))
        assert torch.equal(session.decode_body(z), session.vposer.decode(z))
    off = build_fit_session(slice_config(96, interpenetration=False), device="cpu")
    assert off.vposer is None


@pytest.mark.parametrize("B", [1, 5])
def test_decode_keeps_leading_dimensions(B):
    net = tv.vposer_from_state_dict(tv.random_params(1), device="cpu")
    z = torch.randn(B, 2, tv.LATENT_DIM, generator=torch.Generator().manual_seed(B))
    out = net.decode(z)
    assert out.shape == (B, 2, tv.POSE_DIM)
    assert torch.allclose(out[:, 1], net.decode(z[:, 1]), atol=1e-6)
