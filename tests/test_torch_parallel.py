"""Port parity for `smplifyx_torch/parallel/mesh.py` on the CPU: meshes of
CPU devices, frame blocks and replicas, the vertex-sharded forward against
JAX's `shard_model` forward on the conftest's 8 virtual devices, and the
data-parallel fit in two worker processes against the port's and JAX's
`fit_batch` (the problem of tests/test_sharding.py)."""

import dataclasses
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from smplifyx_tpu.fitting.pipeline import fit_batch as j_fit_batch
from smplifyx_tpu.models.bodymodel import synthetic_model as j_synthetic_model
from smplifyx_tpu.models.forward import BodyParams as JBodyParams
from smplifyx_tpu.models.forward import smplx_forward as j_smplx_forward
from smplifyx_tpu.parallel.mesh import make_mesh as j_make_mesh
from smplifyx_tpu.parallel.mesh import shard_frames as j_shard_frames
from smplifyx_tpu.parallel.mesh import shard_model as j_shard_model

from smplifyx_torch import convert
from smplifyx_torch.fitting.lbfgs import LBFGSConfig
from smplifyx_torch.fitting.pipeline import FitOptions, fit_batch
from smplifyx_torch.models.bodymodel import synthetic_model
from smplifyx_torch.models.forward import BodyParams, smplx_forward
from smplifyx_torch.models.vposer import random_params, vposer_from_state_dict
from smplifyx_torch.ops.collision import make_collision_fn
from smplifyx_torch.ops.lbs import lbs_plan
from smplifyx_torch.parallel import (
    ShardedModel,
    fit_batch_sharded,
    make_mesh,
    replicate,
    shard_frames,
    shard_model,
    to_device,
)
from smplifyx_torch.session import _identity

from tests.test_sharding import _make_problem

B = 4
EDGES = [[5, 12], [2, 9]]


def jfields(obj):
    return {f.name: (np.asarray(getattr(obj, f.name))
                     if hasattr(getattr(obj, f.name), "shape")
                     else getattr(obj, f.name))
            for f in dataclasses.fields(obj)}


@pytest.fixture(scope="module")
def problem():
    """tests/test_sharding.py's problem (V=64, B=4) in both packages."""
    model, settings, options, schedule, frames, x0, joint_map = \
        _make_problem(B)
    port = dict(
        model=convert.smplx_model(jfields(model), "cpu"),
        settings=convert.fit_settings(jfields(settings)),
        options=FitOptions(
            lbfgs=LBFGSConfig(max_iters=10, history=6, max_ls=10),
            camera_lbfgs=LBFGSConfig(max_iters=8, history=6, max_ls=10)),
        stage_weights=convert.stage_weights(jfields(schedule), "cpu"),
        frames=convert.frame_data(jfields(frames), "cpu"),
        x0=torch.as_tensor(np.array(x0)),
        decode_body=_identity,
        joint_map=torch.as_tensor(np.array(joint_map), dtype=torch.int64),
    )
    jax_args = (model, settings, options, schedule, frames, x0, lambda b: b,
                joint_map)
    return port, jax_args


def cpu_mesh(n_data, n_model=1):
    return make_mesh(n_data, n_model, devices=["cpu"] * (n_data * n_model))


class TestMesh:
    def test_make_mesh_shapes(self):
        assert make_mesh(devices=["cpu"] * 8).shape == {"data": 8, "model": 1}
        mesh = make_mesh(n_data=4, n_model=2, devices=["cpu"] * 8)
        assert mesh.shape == {"data": 4, "model": 2}
        assert mesh.lead == torch.device("cpu")
        assert all(d == torch.device("cpu") for row in mesh.devices for d in row)
        with pytest.raises(ValueError, match="needs 6 devices"):
            make_mesh(3, 2, devices=["cpu"] * 4)

    def test_make_mesh_needs_a_card_or_cpu_devices(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(devices=["cuda:0", "cuda:0"])

    def test_shard_frames_blocks(self, problem):
        port, _ = problem
        mesh = cpu_mesh(2)
        blocks = shard_frames(port["frames"], mesh)
        assert len(blocks) == 2
        for r, blk in enumerate(blocks):
            for f in dataclasses.fields(blk):
                want = getattr(port["frames"], f.name)[2 * r:2 * r + 2]
                got = getattr(blk, f.name)
                assert torch.equal(got, want), f.name
                assert got.untyped_storage().data_ptr() != \
                    want.untyped_storage().data_ptr()
        x_blocks = shard_frames(port["x0"], cpu_mesh(4))
        assert [tuple(x.shape) for x in x_blocks] == [(1, port["x0"].shape[1])] * 4
        with pytest.raises(ValueError, match="do not divide"):
            shard_frames(port["x0"], cpu_mesh(3))

    def test_replicate_builds_each_copy_its_plan(self, problem):
        port, _ = problem
        before = lbs_plan.builds
        copies = replicate(port["model"], cpu_mesh(2))
        assert lbs_plan.builds == before + 2
        for m in copies:
            assert m is not port["model"] and m.lbs_plan is not port["model"].lbs_plan
            assert m.lbs_plan == port["model"].lbs_plan
            assert torch.equal(m.posedirs, port["model"].posedirs)
        assert [torch.equal(a, b) for a, b in zip(
            replicate(port["x0"], cpu_mesh(2)), [port["x0"]] * 2)] == [True] * 2

    def test_to_device_moves_callables(self):
        vposer = vposer_from_state_dict(random_params(0), "cpu")
        moved = to_device(vposer.decode, "cpu")
        assert moved.__self__ is not vposer
        z = torch.randn(2, 32)
        assert torch.equal(moved(z), vposer.decode(z))
        faces = torch.randint(0, 50, (40, 3))
        fn = make_collision_fn(faces, segm=np.arange(40) % 5,
                               parents=np.zeros(40, np.int64))
        back = pickle.loads(pickle.dumps(to_device(fn, "cpu")))
        assert back is not fn and torch.equal(back.faces, fn.faces)
        assert torch.equal(back.segm, fn.segm)


class TestVertexShardedForward:
    def params(self):
        return dataclasses.replace(BodyParams.zeros(4, device="cpu"),
                                   body_pose=torch.full((4, 63), 0.05))

    def test_matches_jax_shard_model_forward(self):
        """JAX's test_vertex_sharded_forward_matches: the 4x2 mesh of 8
        virtual devices; the port's model axis is a row of two blocks."""
        jmesh = j_make_mesh(n_data=4, n_model=2)
        jm = j_synthetic_model(num_verts=64, seed=1)
        jp = JBodyParams.zeros(4).replace(body_pose=jnp.full((4, 63), 0.05))
        ref = jax.jit(lambda m, p: j_smplx_forward(m, p, use_face_contour=True)
                      )(j_shard_model(jm, jmesh), j_shard_frames(jp, jmesh))

        tm = synthetic_model(num_verts=64, seed=1, device="cpu")
        sharded = shard_model(tm, cpu_mesh(1, 2))[0]
        assert isinstance(sharded, ShardedModel) and len(sharded.blocks) == 2
        out = smplx_forward(sharded, self.params(), use_face_contour=True)
        plain = smplx_forward(tm, self.params(), use_face_contour=True)
        for name in ("vertices", "joints"):
            got = getattr(out, name).numpy()
            np.testing.assert_allclose(got, np.asarray(getattr(ref, name)),
                                       atol=2e-5, err_msg=name)
            np.testing.assert_allclose(got, getattr(plain, name).numpy(),
                                       atol=2e-5, err_msg=name)

    @pytest.mark.parametrize("V,blocks", [(64, 2), (65, 3)])
    def test_blocks_and_gradient_match_unsharded(self, V, blocks):
        tm = synthetic_model(num_verts=V, seed=2, device="cpu")
        sharded = shard_model(tm, cpu_mesh(1, blocks))[0]
        sizes = [b.v_template.shape[0] for b in sharded.blocks]
        assert sum(sizes) == V and max(sizes) - min(sizes) <= 1
        lo = 0
        for blk, n in zip(sharded.blocks, sizes):
            assert torch.equal(blk.lbs_weights, tm.lbs_weights[lo:lo + n])
            assert torch.equal(blk.posedirs, tm.posedirs[:, 3 * lo:3 * (lo + n)])
            assert torch.equal(blk.J_regressor, tm.J_regressor[:, lo:lo + n])
            assert blk.lbs_plan == lbs_plan(tm.lbs_weights[lo:lo + n])
            lo += n
        rng = np.random.default_rng(0)
        wv = torch.as_tensor(rng.normal(size=(4, V, 3)), dtype=torch.float32)
        grads = []
        for model in (tm, sharded):
            p = self.params()
            p.body_pose.requires_grad_(True)
            p.betas.requires_grad_(True)
            out = smplx_forward(model, p, use_face_contour=True)
            (torch.sum(out.vertices * wv) + out.joints.square().sum()).backward()
            grads.append((out.vertices.detach(), p.body_pose.grad, p.betas.grad))
        for a, b in zip(*grads):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=2e-5,
                                       rtol=1e-5)


class TestDataParallelFit:
    def test_two_workers_match_fit_batch_and_jax(self, problem):
        port, jax_args = problem
        edges = torch.as_tensor(EDGES)
        single = fit_batch(**port, edge_idxs=edges, device="cpu")
        res = fit_batch_sharded(cpu_mesh(2), **port, edge_idxs=edges)
        jres = jax.jit(lambda m, f, x: j_fit_batch(
            m, *jax_args[1:4], f, x, *jax_args[6:], edge_idxs=jnp.asarray(EDGES))
        )(jax_args[0], jax_args[4], jax_args[5])
        assert res.x.shape == single.x.shape and res.x.device.type == "cpu"
        assert res.stage_losses.shape == single.stage_losses.shape
        # f32 L-BFGS trajectories: loss level, 5% per lane (a worker's one
        # intra-op thread sums in another order than the caller's).
        np.testing.assert_allclose(res.loss.numpy(), single.loss.numpy(),
                                   rtol=0.05)
        np.testing.assert_allclose(res.loss.numpy(), np.asarray(jres.loss),
                                   rtol=0.05)
        run = fit_batch_sharded.last_run
        assert len(run["rows"]) == 2
        assert all(r["fit_s"] > 0 and r["startup_s"] > 0 for r in run["rows"])

    def test_workers_bit_equal_to_fit_batch_on_their_blocks(self, problem):
        """A worker runs fit_batch on its block and nothing else: with the
        caller at one intra-op thread too, the lanes equal the bits of
        fit_batch on the same blocks (a lane's rounding depends on its
        batch's size, so the blocks, not the whole batch, are the
        reference)."""
        port, _ = problem
        edges = torch.as_tensor(EDGES)
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            blocks = [fit_batch(**{**port, "x0": port["x0"][2 * r:2 * r + 2],
                                   "frames": port["frames"].map(
                                       lambda a, r=r: a[2 * r:2 * r + 2])},
                                edge_idxs=edges, device="cpu")
                      for r in range(2)]
        finally:
            torch.set_num_threads(threads)
        res = fit_batch_sharded(cpu_mesh(2), **port, edge_idxs=edges)
        for name, dim in (("x", 0), ("loss", 0), ("camera_loss", 0),
                          ("stage_losses", 1), ("stage_evals", 1)):
            want = torch.cat([getattr(b, name) for b in blocks], dim)
            assert torch.equal(getattr(res, name), want), name
        assert res.host_reads == sum(b.host_reads for b in blocks)

    def test_vertex_sharded_worker_matches_fit_batch(self, problem):
        port, _ = problem
        edges = torch.as_tensor(EDGES)
        half = {**port, "frames": port["frames"].map(lambda a: a[:2]),
                "x0": port["x0"][:2]}
        single = fit_batch(**half, edge_idxs=edges, device="cpu")
        res = fit_batch_sharded(cpu_mesh(1, 2), **half, edge_idxs=edges,
                                shard_model_axis=True)
        np.testing.assert_allclose(res.loss.numpy(), single.loss.numpy(),
                                   rtol=0.05)

    def test_lambda_raises(self, problem):
        port, _ = problem
        with pytest.raises(TypeError, match="decode_body.*worker process"):
            fit_batch_sharded(cpu_mesh(2), **{**port,
                                              "decode_body": lambda b: b},
                              edge_idxs=torch.as_tensor(EDGES))

    def test_worker_error_reaches_caller(self, problem):
        port, _ = problem
        with pytest.raises(RuntimeError, match="(?s)data row [01] .*Traceback.*"
                           "coll_stage_mask needs one entry per stage"):
            fit_batch_sharded(cpu_mesh(2), **port,
                              edge_idxs=torch.as_tensor(EDGES),
                              coll_stage_mask=(False,))
