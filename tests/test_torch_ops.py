"""Port parity: leaf ops, joint-mapping tables and Config against the JAX
package, on the CPU.  Inputs come from numpy seeds and go to both."""

import dataclasses
import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.models import joint_mapping as jmap
from smplifyx_tpu.ops import camera as jcam
from smplifyx_tpu.ops import robustifier as jrob
from smplifyx_tpu.ops import rotation as jrot
from smplifyx_tpu.priors import priors as jpri
from smplifyx_tpu.utils import config as jconfig

from smplifyx_torch.models import joint_mapping as tmap
from smplifyx_torch.ops import camera as tcam
from smplifyx_torch.ops import robustifier as trob
from smplifyx_torch.ops import rotation as trot
from smplifyx_torch.priors import priors as tpri
from smplifyx_torch.utils import config as tconfig


def _aa_cases():
    rng = np.random.default_rng(0)
    aa = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    aa[0] = 0.0                                   # zero angle
    aa[1] = [0.0, np.pi, 0.0]                     # pi about y
    aa[2] = np.array([1.0, -2.0, 0.5]) / np.linalg.norm([1.0, -2.0, 0.5]) * np.pi
    aa[3] = [1e-7, 0.0, -1e-7]                    # tiny
    return aa


class TestRotation:
    def test_rodrigues_values(self):
        aa = _aa_cases()
        ref = np.asarray(jax.jit(jrot.batch_rodrigues)(jnp.asarray(aa)))
        out = trot.batch_rodrigues(torch.as_tensor(aa)).numpy()
        # f32 transcendental rounding differs between XLA and torch.
        np.testing.assert_allclose(out, ref, atol=2e-6)

    def test_rodrigues_gradients_finite_at_zero(self):
        aa = _aa_cases()
        w = np.random.default_rng(1).normal(size=(64, 3, 3)).astype(np.float32)
        gj = np.asarray(jax.jit(jax.grad(
            lambda a: jnp.sum(jrot.batch_rodrigues(a) * w)))(jnp.asarray(aa)))
        x = torch.as_tensor(aa).requires_grad_(True)
        torch.sum(trot.batch_rodrigues(x) * torch.as_tensor(w)).backward()
        gt = x.grad.numpy()
        assert np.isfinite(gt).all()
        # The gradient near zero angle divides by the smoothed angle (1e-8),
        # so the tiny-angle rows carry ~1e-6 relative rounding noise.
        np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-4)

    def test_rotmat_to_aa_and_flip(self):
        aa = _aa_cases()
        R = np.array(jax.jit(jrot.batch_rodrigues)(jnp.asarray(aa)))
        ref = np.asarray(jax.jit(jrot.rotmat_to_aa)(jnp.asarray(R)))
        out = trot.rotmat_to_aa(torch.as_tensor(R)).numpy()
        np.testing.assert_allclose(out, ref, atol=2e-5)
        ref_f = np.asarray(jax.jit(jrot.flip_global_orient_y)(jnp.asarray(aa)))
        out_f = trot.flip_global_orient_y(torch.as_tensor(aa)).numpy()
        # Near pi the axis comes from sqrt((diag + 1) / 2): ~1e-4 in f32.
        np.testing.assert_allclose(out_f, ref_f, atol=5e-4)

    def test_euler_xyz(self):
        aa = _aa_cases()
        R = np.array(jax.jit(jrot.batch_rodrigues)(jnp.asarray(aa)))
        ref = np.asarray(jax.jit(jrot.euler_xyz_from_rotmat)(jnp.asarray(R)))
        out = trot.euler_xyz_from_rotmat(torch.as_tensor(R)).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-5)


class TestCameraAndRobustifier:
    def test_project_points_with_z_clamp(self):
        rng = np.random.default_rng(2)
        B, N = 4, 20
        pts = rng.normal(0, 1.0, (B, N, 3)).astype(np.float32)
        pts[:, 0, 2] = 0.0          # on the camera plane: clamp to +1e-6
        pts[:, 1, 2] = -5e-7        # just behind it: clamp to -1e-6
        R = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
        t = np.zeros((B, 3), np.float32)
        f = rng.uniform(500, 1500, (B, 2)).astype(np.float32)
        c = rng.uniform(100, 400, (B, 2)).astype(np.float32)
        ref = np.asarray(jcam.project_points(
            jcam.CameraParams(*map(jnp.asarray, (R, t, f, c))), jnp.asarray(pts)))
        out = tcam.project_points(
            tcam.CameraParams(*map(torch.as_tensor, (R, t, f, c))),
            torch.as_tensor(pts)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        assert np.isfinite(out).all()

    def test_gmof(self):
        r = np.random.default_rng(3).normal(0, 200.0, (50, 2)).astype(np.float32)
        ref = np.asarray(jrob.gmof(jnp.asarray(r), 100.0))
        out = trob.gmof(torch.as_tensor(r), 100.0).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-6)


class TestPriors:
    def test_l2_and_angle_prior_with_exponent_clamp(self):
        rng = np.random.default_rng(4)
        pose = rng.normal(0, 1.0, (6, 63)).astype(np.float32)
        pose[0, 52] = 80.0      # left elbow far past the clamp at +40
        pose[1, 9] = -90.0      # knee (sign -1) past it too
        for with_global in (False, True):
            p = np.concatenate([np.zeros((6, 3), np.float32), pose], -1) \
                if with_global else pose
            ref = np.asarray(jpri.angle_prior(jnp.asarray(p), with_global))
            out = tpri.angle_prior(torch.as_tensor(p), with_global).numpy()
            assert np.isfinite(out).all()
            np.testing.assert_allclose(out, ref, rtol=1e-6)
        x = rng.normal(size=(6, 4, 3)).astype(np.float32)
        np.testing.assert_allclose(tpri.l2_prior(torch.as_tensor(x)).numpy(),
                                   np.asarray(jpri.l2_prior(jnp.asarray(x))),
                                   rtol=1e-6)


class TestTablesAndConfig:
    @pytest.mark.parametrize("fmt", ["coco25", "coco19", "halpe",
                                     "coco_wholebody"])
    def test_joint_mapping_tables_equal(self, fmt):
        models = ["smplx", "smplh", "smpl"] if fmt in ("coco25", "coco19") \
            else ["smplx"]
        for model_type in models:
            for contour in (False, True):
                np.testing.assert_array_equal(
                    tmap.model_to_annotation(model_type, True, True, contour, fmt),
                    jmap.model_to_annotation(model_type, True, True, contour, fmt))
        assert tmap.SHOULDER_IDXS_BY_FORMAT == jmap.SHOULDER_IDXS_BY_FORMAT

    @pytest.mark.parametrize("preset", sorted(glob.glob(os.path.join(
        os.path.dirname(__file__), "..", "cfg", "*.yaml"))))
    def test_config_loads_like_jax(self, preset):
        t = tconfig.load_config(preset)
        j = jconfig.load_config(preset)
        assert ([f.name for f in dataclasses.fields(t)]
                == [f.name for f in dataclasses.fields(j)])
        for f in dataclasses.fields(j):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        for prop in ("resolved_ls_mode", "resolved_lbfgs_iters",
                     "resolved_max_evals", "resolved_coll_broad_every",
                     "resolved_max_line_search", "resolved_ls_soft_accept",
                     "num_stages", "body_tri_pairs"):
            assert getattr(t, prop) == getattr(j, prop), prop
