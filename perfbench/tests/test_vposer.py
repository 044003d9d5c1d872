"""VPoser in the harness at a small size on the CPU: the seeded checkpoint,
the truth drawn in the decoder's image, and the plain reference's decoder,
encoder and energy against the program's.

Tolerances of float32 (the program) against float64 (the reference): a
decode passes three products of up to 512 terms and the 6D and log-map
chains, so its poses agree to 1e-5 rad (measured ~5e-7 at the traffic's
latent spread); an encode's means, of up to ~4, to 2e-5.  Near a half
turn float32's log map takes the axis from square roots of (1 + a
diagonal entry) / 2, which keeps only half of float32's digits in the
small components: 2e-4 rad there (measured 4.7e-5 at pi - 1e-3)."""

import ast
import math
import os.path as osp
import subprocess
import sys
import tempfile

import pytest
import torch

from perfbench import generate
from perfbench import reference as ref
from perfbench.cell import Program, _merge, _records
from perfbench.manifest import ROOT, Manifest
from perfbench.tests._vposer import ARMS_LOWERED, VPOSER

SEED = 3_100_000_019
CFG = VPOSER["config"]["vposer"]
LATENT = VPOSER["config"]["preset"]["vposer_latent_dim"]
DECODE_TOL, ENCODE_TOL, NEAR_PI_TOL = 1e-5, 2e-5, 2e-4


def _mean_pose():
    mean = torch.zeros(63, dtype=torch.float64)
    for i, v in ARMS_LOWERED:
        mean[i] += v
    return mean


@pytest.fixture(scope="module")
def vposers():
    """(state_dict, the reference's VPoser, the program's VPoser)."""
    from smplifyx_torch.models.vposer import load_vposer

    sd = generate.vposer_params(CFG, LATENT, SEED, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        path = generate.write_vposer(sd, tmp)
        yield sd, ref.VPoser(path, torch.float64, "cpu"), load_vposer(path,
                                                                       "cpu")


def test_the_checkpoint_is_the_seeds_and_decodes_the_mean_pose_at_zero(vposers):
    sd, mine, _ = vposers
    again = generate.vposer_params(CFG, LATENT, SEED, "cpu")
    other = generate.vposer_params(CFG, LATENT, SEED + 1, "cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    assert not torch.equal(sd["bodyprior_dec_fc1.weight"],
                           other["bodyprior_dec_fc1.weight"])
    assert (mine.latent_dim, mine.hidden, mine.num_joints) == (32, 512, 21)
    zero = mine.decode(torch.zeros(1, 32, dtype=torch.float64))[0]
    assert (zero - _mean_pose()).abs().max() < 1e-6
    # the running statistics lie away from the identity
    for bn in ("bodyprior_enc_bn1", "bodyprior_enc_bn2"):
        assert sd[bn + ".running_mean"].abs().max() > 0.1
        assert (sd[bn + ".running_var"] - 1).abs().min() > 0.5


def test_the_reference_decodes_and_encodes_as_the_program(vposers):
    _, mine, prog = vposers
    g = torch.Generator().manual_seed(1)
    z = torch.randn(256, 32, generator=g, dtype=torch.float64) * 3.0
    gap = (prog.decode(z.float()).double() - mine.decode(z)).abs().max()
    assert gap < DECODE_TOL
    pose = _mean_pose() + torch.randn(256, 63, generator=g,
                                      dtype=torch.float64) * 0.3
    gap = (prog.encode_mean(pose.float()).double()
           - mine.encode_mean(pose)).abs().max()
    assert gap < ENCODE_TOL


@pytest.mark.parametrize("short", [1e-2, 1e-3, 1e-4])
def test_near_a_half_turn_both_decode_the_same_pose(vposers, short):
    """Joint 0's output rows set to a constant rotation by pi - short, so
    that every latent decodes to it there."""
    from smplifyx_torch.models.vposer import vposer_from_state_dict

    sd = dict(vposers[0])
    axis = torch.tensor([0.3, -0.5, 0.8], dtype=torch.float64)
    aa = axis / axis.norm() * (math.pi - short)
    six = ref.rodrigues(aa[None])[0, :, :2].reshape(6)
    w = sd["bodyprior_dec_out.weight"].clone()
    b = sd["bodyprior_dec_out.bias"].clone()
    w[:6] = 0
    b[:6] = six.float()
    sd["bodyprior_dec_out.weight"], sd["bodyprior_dec_out.bias"] = w, b
    prog = vposer_from_state_dict(sd, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        mine = ref.VPoser(generate.write_vposer(sd, tmp), torch.float64, "cpu")
    z = torch.randn(8, 32, generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    ours, theirs = mine.decode(z), prog.decode(z.float()).double()
    assert (ours[:, :3] - aa).abs().max() < 1e-6     # the bias is float32
    assert (theirs[:, :3] - ours[:, :3]).abs().max() < NEAR_PI_TOL
    assert (theirs[:, 3:] - ours[:, 3:]).abs().max() < DECODE_TOL


def test_the_log_map_inverts_rodrigues_at_every_angle():
    g = torch.Generator().manual_seed(3)
    aa = torch.randn(2000, 3, generator=g, dtype=torch.float64)
    aa = aa / aa.norm(dim=-1, keepdim=True) * torch.cat([
        torch.rand(1990, 1, generator=g, dtype=torch.float64) * math.pi,
        torch.tensor([[0.0], [1e-9], [math.pi / 2], [math.pi - 1e-8],
                      [math.pi - 1e-3], [1.0], [2.0], [3.0], [0.5], [1e-4]],
                     dtype=torch.float64)])
    assert (ref.log_map(ref.rodrigues(aa)) - aa).abs().max() < 1e-7
    R = ref.rodrigues(aa[:50]).requires_grad_(True)
    g, = torch.autograd.grad(ref.log_map(R).sum(), R)
    assert torch.isfinite(g).all()


def test_the_truth_lies_in_the_decoders_image(vposers):
    """Under `vposer_latent_std` the body poses are the latents' decodes,
    spread about 0.12 rad per component; every other draw stays."""
    _, mine, _ = vposers
    traffic = _merge(Manifest().traffic("offline-b128"), VPOSER["traffic"])
    plain = generate.ground_truth(traffic, 512, 1000.0, SEED, "cpu", 12, 10, 10)
    gt = generate.ground_truth(traffic, 512, 1000.0, SEED, "cpu", 12, 10, 10,
                               mine)
    z = generate.truth_latents(traffic, 512, 32, SEED, "cpu")
    assert torch.equal(gt["body_pose"], mine.decode(z))
    for k in gt:
        if k != "body_pose":
            assert torch.equal(gt[k], plain[k]), k
    spread = (gt["body_pose"] - _mean_pose()).std(0).mean()
    assert 0.10 < spread < 0.14


def test_a_vposer_truth_needs_the_traffics_latent_spread(vposers):
    """No axis-angle truth for a VPoser configuration: most such poses lie
    outside a seeded decoder's image, and a sound fit would read as a bad
    `reproj_px`."""
    _, mine, _ = vposers
    traffic = Manifest().traffic("offline-b128")
    with pytest.raises(KeyError, match="vposer_latent_std"):
        generate.ground_truth(traffic, 4, 1000.0, SEED, "cpu", 12, 10, 10,
                              mine)


# The arms lowered into the body at z = 0, so that the collision term
# weighs in the last stage.
PRESSED = [[47, -1.6], [50, 1.6], [52, -0.3], [55, 0.3]]


@pytest.fixture(scope="module")
def setup():
    conf = _merge(Manifest().config("smplx-combined-coco25"),
                  _merge(VPOSER["config"],
                         {"model": {"num_verts": 500, "num_faces": 900},
                          "vposer": {"mean_pose": PRESSED}}))
    tmp = tempfile.TemporaryDirectory()
    paths = generate.write_model(generate.body_model(conf["model"], SEED,
                                                     "cpu"), tmp.name)
    paths["vposer"] = generate.write_vposer(
        generate.vposer_params(conf["vposer"], LATENT, SEED, "cpu"), tmp.name)
    prog = Program(conf, paths, "cpu")
    body = ref.Body(paths["model"], {**conf["model"], "num_pca_comps": 12},
                    torch.float64, "cpu")
    vposer = ref.VPoser(paths["vposer"], torch.float64, "cpu")
    yield conf, paths, prog, body, vposer
    tmp.cleanup()


@pytest.mark.parametrize("stage", [0, 2])
def test_energy_and_gradient_equal_the_programs_under_vposer(setup, stage):
    """The latent in the flat vector, decoded for the forward and the
    bending prior; the pose prior |z|^2 in stage 0 and, under the
    regression prior, |z - encode_mean(reg)|^2 in the last; with the arms
    pressed into the body, so that the collision term is in the sum."""
    conf, paths, prog, body, vposer = setup
    s = prog.session
    assert s.settings.dim == ref.layout(conf["preset"])["rhand"][0] + 12
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, s.settings.dim, generator=g) * 0.1
    x[:, 2] += 4.0
    off = ref.layout(conf["preset"])["body"][0]
    x[:, off:off + 32] = torch.randn(2, 32, generator=g) * 0.3
    kp = torch.rand(2, 135, 3, generator=g) * torch.tensor([800.0, 600.0, 1.0])
    reg = {"body_pose": (_mean_pose() + torch.randn(2, 63, generator=g,
                                                    dtype=torch.float64) * 0.1)
           .float().numpy(),
           "global_orient": torch.zeros(2, 3).numpy(),
           "cam_t": x[:, :3].numpy()}
    records, regression = _records(kp.numpy(), reg, (600, 800), 0)
    prep = prog._prep.prepare_batch(prog.cfg, records, prog.joint_weights,
                                    regression=regression,
                                    vposer=s.vposer, device="cpu")
    xg = x.clone().requires_grad_(True)
    theirs = prog._pipeline.smplify_energy(
        xg, s.settings, prog.model, prep.frames, s.schedule.stage(stage),
        stage, s.schedule.num_stages, s.decode_body, s.joint_map,
        joints_model=prog.joints_model,
        collision_fn=s.collision_for(prog.model))
    their_grad, = torch.autograd.grad(theirs.sum(), xg)
    coll = ref.Collision(body.faces, paths["part_segm"], conf["preset"])
    xd = x.double().requires_grad_(True)
    e = ref.energy(body, conf["preset"], xd, kp, 1000.0, (600, 800), coll,
                   stage=stage, reg_body=torch.as_tensor(reg["body_pose"])
                   .double(), vposer=vposer)
    mine, = torch.autograd.grad(e["total"].sum(), xd)
    assert bool((e["terms"]["collision"] > 0).all()) is (stage == 2)
    assert torch.allclose(theirs.double(), e["total"].detach(), rtol=1e-4)
    assert ((their_grad.double() - mine).norm(dim=-1)
            <= 1e-3 * mine.norm(dim=-1)).all()
    # the latent's gradient comes through the decoder, not the prior alone
    prior = 2 * conf["preset"]["body_pose_prior_weights"][stage] ** 2 \
        * xd[:, off:off + 32]
    latent = mine[:, off:off + 32]
    assert (latent - prior).norm() > 1e-3 * latent.norm()


def test_the_reference_imports_nothing_of_the_program():
    tree = ast.parse(open(osp.join(ROOT, "perfbench", "reference.py")).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "contextlib", "math", "pickle", "numpy",
                     "torch"}, names
    code = ("import sys, json\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "import perfbench.reference\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'smplifyx_torch', 'smplifyx_tpu', 'jax', 'jaxlib', 'flax'})))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"

