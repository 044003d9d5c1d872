"""The plain reference against the program at a small size on the CPU:
the forward, the energy and its gradient with a broad phase run at x, and
the collision pairs."""

import tempfile

import pytest
import torch

from perfbench import generate
from perfbench import reference as ref
from perfbench.cell import Program, _merge, _records
from perfbench.manifest import Manifest

SEED = 11


@pytest.fixture(scope="module")
def setup():
    torch.manual_seed(0)
    conf = _merge(Manifest().config("smplx-combined-coco25"),
                  {"model": {"num_verts": 500, "num_faces": 900}})
    tmp = tempfile.TemporaryDirectory()
    m = generate.body_model(conf["model"], SEED, "cpu")
    paths = generate.write_model(m, tmp.name)
    prog = Program(conf, paths, "cpu")
    body = ref.Body(paths["model"], {**conf["model"], "num_pca_comps": 12},
                    torch.float64, "cpu")
    yield conf, paths, prog, body
    tmp.cleanup()


def _x(prog, n=3, scale=0.2):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(n, prog.session.settings.dim, generator=g) * scale
    x[:, 2] = 4.0 + x[:, 2]          # the camera in front of the body
    return x


def _pose(conf, x, arms=0.0):
    """Parameters of x with the arms lowered by `arms` rad."""
    seg = ref.unpack(conf["preset"], x.double())
    pose = seg["body"].clone()
    pose[:, 47] -= arms
    pose[:, 50] += arms
    return ref.params_of(seg, pose)


def test_forward_equals_the_programs(setup):
    conf, paths, prog, body = setup
    from smplifyx_torch.fitting.pipeline import recover_outputs

    x = _x(prog)
    s = prog.session
    out, _, _ = recover_outputs(prog.model, s.settings, x, s.decode_body,
                                joint_map=s.joint_map, device="cpu")
    mine = body.forward(_pose(conf, x))
    assert (out.vertices.double() - mine["vertices"]).abs().max() < 1e-5
    assert (out.joints.double() - mine["joints"]).abs().max() < 1e-5


def test_energy_and_gradient_equal_the_programs_with_a_broad_phase_at_x(setup):
    """With the arms lowered into the body, so that the collision term and
    its gradient (K2, K3) are in the sum; the regression prior's pose is
    the reference's and the program's alike."""
    conf, paths, prog, body = setup
    x = _x(prog, 2, 0.1)
    x[:, 6 + 44] -= 1.5
    x[:, 6 + 47] += 1.5
    kp = torch.rand(2, 135, 3) * torch.tensor([800.0, 600.0, 1.0])
    g = torch.Generator().manual_seed(3)
    reg = {"body_pose": (torch.randn(2, 63, generator=g) * 0.1).numpy(),
           "global_orient": torch.zeros(2, 3).numpy(),
           "cam_t": x[:, :3].numpy()}
    records, regression = _records(kp.numpy(), reg, (600, 800), 0)
    prep = prog._prep.prepare_batch(prog.cfg, records, prog.joint_weights,
                                    regression=regression, device="cpu")
    theirs, their_grad = prog.energy(prep.frames, x)
    coll = ref.Collision(body.faces, paths["part_segm"], conf["preset"])
    xd = x.double().requires_grad_(True)
    e = ref.energy(body, conf["preset"], xd, kp, 1000.0, (600, 800), coll,
                   reg_body=torch.as_tensor(reg["body_pose"]))
    mine, = torch.autograd.grad(e["total"].sum(), xd)
    assert (e["terms"]["collision"] > 0).all()
    assert torch.allclose(theirs.double(), e["total"].detach(), rtol=1e-4)
    assert ((their_grad.double() - mine).norm(dim=-1)
            <= 1e-3 * mine.norm(dim=-1)).all()


def test_collision_pairs_equal_the_broad_phase(setup):
    conf, paths, prog, body = setup
    x = _x(prog, 2, 0.3)
    v = body.forward(_pose(conf, x, 1.5))["vertices"]
    coll = ref.Collision(body.faces, paths["part_segm"], conf["preset"])
    a, b, valid = prog.session.collision_fn.candidate_pairs(v.float())
    for lane in range(2):
        theirs = {tuple(sorted(p)) for p in zip(a[lane][valid[lane]].tolist(),
                                                 b[lane][valid[lane]].tolist())}
        mine = {tuple(p) for p in coll.pairs(v[lane]).tolist()}
        assert mine and theirs == mine


def test_rodrigues_is_a_rotation():
    aa = torch.randn(50, 3, dtype=torch.float64)
    R = ref.rodrigues(aa)
    eye = torch.eye(3, dtype=torch.float64)
    assert torch.allclose(R @ R.transpose(-1, -2), eye.expand(50, 3, 3),
                          atol=1e-12)
    assert torch.allclose(torch.linalg.det(R), torch.ones(50, dtype=torch.float64))
    quarter = ref.rodrigues(torch.tensor([[0.0, 0.0, torch.pi / 2]],
                                         dtype=torch.float64))[0]
    assert torch.allclose(quarter @ torch.tensor([1.0, 0, 0], dtype=torch.float64),
                          torch.tensor([0.0, 1, 0], dtype=torch.float64),
                          atol=1e-12)
    assert torch.equal(ref.rodrigues(torch.zeros(1, 3)), torch.eye(3)[None])


def test_procrustes_removes_a_similarity():
    g = torch.Generator().manual_seed(0)
    S = torch.randn(2, 40, 3, generator=g, dtype=torch.float64)
    R = ref.rodrigues(torch.tensor([[0.3, -0.2, 0.5]], dtype=torch.float64))
    moved = 1.7 * S @ R.transpose(-1, -2) + 0.4
    assert ref.pa_v2v_mm(moved, S).max() < 1e-9
