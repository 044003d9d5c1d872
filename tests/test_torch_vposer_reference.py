"""The port under the combined VPoser preset against the benchmark's plain
reference (`perfbench/reference.py`: float64 torch, nothing of the port and
no JAX), on the CPU with a mesh of 1,000 vertices, the benchmark's
configuration otherwise (`perfbench/configs/smplx-combined-vposer-coco25.json`)
and a seeded VPoser v1 of the published widths: the decoder
and the encoder's mean, and the energy with its gradient with respect to
the latent in the camera stage, in a collision body stage and in the last
stage, where the pose prior is the latent's distance from the encoded
regressor pose.

The port is built through its public entry points, as a user builds it:
the configuration's preset as a `Config`, the model file, `build_fit_session`
and `prepare_batch`.  The reference has
no camera stage; its objective is written here from the reference's
forward, projection and decoder (`camera_init_energy`'s form: the squared
2D error over the camera-init joints, times the sum of their squared
confidences and data_weight^2, plus the depth pull).

Tolerances, float32 (the port) against float64:
  DECODE_TOL  a decode passes three products of up to 512 terms and the 6D
              and log-map chains: poses agree to 1e-5 rad (measured 9e-7
              at latents of 3 a component);
  ENCODE_TOL  the encoder's means, of up to ~3, to 2e-5 (measured 1.1e-6);
  ENERGY_RTOL the energy of a collision stage is mostly the collision
              term (1e6-1e7 here), whose cones scale float32's rounding of
              vertex distances by 1/sigma = 1e4: relative 1e-4 (measured
              up to 8.7e-6; 6e-8 in the camera stage);
  GRAD_RTOL   a gradient's distance from float64's over its length, the
              latent's block alone too: 1e-3 (measured up to 8e-5), the
              benchmark's limit on the card's fits being 2e-2.
"""

import json
import os.path as osp
import tempfile
from types import SimpleNamespace

import pytest
import torch

import smplifyx_torch.fitting.pipeline as pipeline
from perfbench import generate
from perfbench import reference as ref
from smplifyx_torch.data.keypoints import FrameRecord
from smplifyx_torch.data.regressors import RegressionPrior
from smplifyx_torch.fitting.prepare import prepare_batch
from smplifyx_torch.models.bodymodel import load_body_model
from smplifyx_torch.models.sparse import build_joints_model
from smplifyx_torch.session import build_fit_session
from smplifyx_torch.utils.config import Config

SEED = 3_100_000_023
CONFIG = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                  "perfbench", "configs", "smplx-combined-vposer-coco25.json")
# A mesh the CPU evaluates in seconds; every width of the configuration
# is kept.
SMALL_MESH = {"num_verts": 1000, "num_faces": 1950}
DECODE_TOL, ENCODE_TOL = 1e-5, 2e-5
ENERGY_RTOL, GRAD_RTOL = 1e-4, 1e-3
# The arms lowered into the body at z = 0, so that the collision term
# weighs in the collision stages.
PRESSED = [[47, -1.6], [50, 1.6], [52, -0.3], [55, 0.3]]
N = 3


def _port(preset: dict, paths: dict):
    """The port under `preset` with the model, part segmentation and
    VPoser checkpoint at `paths`, on the CPU."""
    cfg = Config(**{**preset, "part_segm_fn": paths["part_segm"],
                    "vposer_ckpt": paths["vposer"]}).validate()
    model = load_body_model(
        paths["model"], "smplx", num_betas=cfg.num_betas,
        num_expression_coeffs=cfg.num_expression_coeffs,
        num_pca_comps=cfg.num_pca_comps, device=torch.device("cpu"))
    return SimpleNamespace(
        model=model, joints_model=build_joints_model(model),
        session=build_fit_session(cfg, model=model, device=torch.device("cpu")))


@pytest.fixture(scope="module")
def setup():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    with open(CONFIG) as f:
        conf = json.load(f)
    conf["model"].update(SMALL_MESH)
    conf["vposer"]["mean_pose"] = PRESSED
    preset = conf["preset"]
    tmp = tempfile.TemporaryDirectory()
    try:
        paths = generate.write_model(generate.body_model(conf["model"], SEED,
                                                         "cpu"), tmp.name)
        paths["vposer"] = generate.write_vposer(generate.vposer_params(
            conf["vposer"], preset["vposer_latent_dim"], SEED, "cpu"),
            tmp.name)
        prog = _port(preset, paths)
        body = ref.Body(paths["model"], {**conf["model"], "num_pca_comps":
                                         preset["num_pca_comps"]},
                        torch.float64, "cpu")
        vposer = ref.VPoser(paths["vposer"], torch.float64, "cpu")
        coll = ref.Collision(body.faces, paths["part_segm"], preset)
        g = torch.Generator().manual_seed(4)
        lay = ref.layout(preset)
        x = torch.randn(N, prog.session.settings.dim, generator=g) * 0.1
        x[:, 2] += 4.0
        off = lay["body"][0]
        x[:, off:off + 32] = torch.randn(N, 32, generator=g) * 0.3
        kp = torch.rand(N, 135, 3, generator=g) \
            * torch.tensor([800.0, 600.0, 1.0])
        mean = torch.zeros(63, dtype=torch.float64)
        for i, v in PRESSED:
            mean[i] = v
        reg = {"body_pose": (mean + torch.randn(N, 63, generator=g,
                                                dtype=torch.float64) * 0.1)
               .float().numpy(),
               "global_orient": torch.zeros(N, 3).numpy(),
               "cam_t": (x[:, :3] + 0.05).numpy()}
        records = [FrameRecord(fn=f"f{i}", img_path="",
                               keypoints=kp[i].numpy()[None],
                               img_size=(600, 800)) for i in range(N)]
        regression = [RegressionPrior(body_pose=reg["body_pose"][i],
                                      global_orient=reg["global_orient"][i],
                                      init_translation=reg["cam_t"][i])
                      for i in range(N)]
        prep = prepare_batch(prog.session.cfg, records,
                             prog.session.joint_weights(),
                             regression=regression, vposer=prog.session.vposer,
                             device="cpu")
        yield dict(conf=conf, prog=prog, body=body, vposer=vposer, coll=coll,
                   x=x, kp=kp, reg=torch.as_tensor(reg["body_pose"]).double(),
                   prep=prep, off=off)
    finally:
        tmp.cleanup()
        torch.set_num_threads(old)


def test_decode_and_encode_mean_equal_the_references(setup):
    prog, mine = setup["prog"].session.vposer, setup["vposer"]
    g = torch.Generator().manual_seed(1)
    z = torch.randn(64, 32, generator=g, dtype=torch.float64) * 3.0
    gap = (prog.decode(z.float()).double() - mine.decode(z)).abs().max()
    assert gap < DECODE_TOL
    pose = setup["reg"][:1] + torch.randn(64, 63, generator=g,
                                          dtype=torch.float64) * 0.3
    gap = (prog.encode_mean(pose.float()).double()
           - mine.encode_mean(pose)).abs().max()
    assert gap < ENCODE_TOL
    # prepare_batch starts each frame's latent at its encoded regressor pose
    start = setup["prep"].x0[:, setup["off"]:setup["off"] + 32].double()
    assert (start - mine.encode_mean(setup["reg"])).abs().max() < ENCODE_TOL


def _camera_reference(s, x):
    """The camera stage's objective from the reference's parts, float64."""
    preset, body, frames = s["conf"]["preset"], s["body"], s["prep"].frames
    seg = ref.unpack(preset, x)
    out = body.forward(ref.params_of(seg, s["vposer"].decode(seg["body"])))
    proj = ref.project(out["joints"], seg["cam_t"], frames.focal[0, 0].item(),
                       frames.center[0].double())
    mask = frames.init_joints_mask.double()
    gt = frames.gt_joints.double()
    joint = ((gt - proj) ** 2 * mask[..., None]).sum((1, 2)) \
        * ((frames.conf.double() * mask) ** 2).sum(-1)
    depth = (frames.depth_loss_weight.double() ** 2
             * (seg["cam_t"][:, 2] - frames.trans_estimation[:, 2].double())
             ** 2)
    return joint * frames.data_weight.double() ** 2 + depth


@pytest.mark.parametrize("stage", ["camera", 1, 2])
def test_energy_and_latent_gradient_equal_the_references(setup, stage):
    """Stage 1 scores the collision term under the prior |z|^2; stage 2,
    the last, under |z - encode_mean(reg)|^2 with the collision term."""
    s, prog = setup, setup["prog"]
    sess, preset, off = prog.session, setup["conf"]["preset"], setup["off"]
    xg = s["x"].clone().requires_grad_(True)
    xd = s["x"].double().requires_grad_(True)
    if stage == "camera":
        theirs = pipeline.camera_init_energy(
            xg, sess.settings, prog.model, s["prep"].frames, sess.decode_body,
            sess.joint_map, joints_model=prog.joints_model)
        mine = _camera_reference(s, xd)
    else:
        theirs = pipeline.smplify_energy(
            xg, sess.settings, prog.model, s["prep"].frames,
            sess.schedule.stage(stage), stage, sess.schedule.num_stages,
            sess.decode_body, sess.joint_map, joints_model=prog.joints_model,
            collision_fn=sess.collision_for(prog.model))
        e = ref.energy(s["body"], preset, xd, s["kp"], s["prep"].frames
                       .focal[0, 0].item(), (600, 800), s["coll"], stage=stage,
                       reg_body=s["reg"], vposer=s["vposer"])
        assert bool((e["terms"]["collision"] > 0).all())
        mine = e["total"]
    their_grad, = torch.autograd.grad(theirs.sum(), xg)
    my_grad, = torch.autograd.grad(mine.sum(), xd)
    assert torch.allclose(theirs.double(), mine.detach(), rtol=ENERGY_RTOL,
                          atol=0)
    for lo, hi in ((0, xd.shape[1]), (off, off + 32)):
        a, b = their_grad[:, lo:hi].double(), my_grad[:, lo:hi]
        assert ((a - b).norm(dim=-1) <= GRAD_RTOL * b.norm(dim=-1)).all()
    # the latent's gradient comes through the decoder
    assert my_grad[:, off:off + 32].abs().max() > 0
