"""The combined configuration reads what it read before the harness could
take a VPoser configuration: its generated model, truth, keypoints and
regressors' estimates at a small size, and the reference's energy and
gradient at a seeded x, against numbers recorded with the same code on
the commit before that change; and a tiny run of it reads `correct`.
The harness owns what is pinned; the tiny run's check values come from
the program's own fit, which a later change to the program's rounding
may move, so they are held only to their limits.

Each array is pinned by two float64 sums, plain and weighted by a cosine
over its flat index (a permutation moves the second); a redrawn stream
moves both by far more than the relative 1e-9 allowed."""

import math
import tempfile

import pytest
import torch

from perfbench import generate
from perfbench import reference as ref
from perfbench.cell import _merge, run_cell
from perfbench.manifest import Manifest
from perfbench.tests._tiny import CELL, TINY

SEED = 2_300_000_011
REL = 1e-9


def _digest(t: torch.Tensor) -> list:
    v = t.detach().double().flatten()
    w = torch.cos(torch.arange(v.numel(), dtype=torch.float64))
    return [float(v.sum()), float((v * w).sum())]


def readings() -> dict:
    """Every pinned number, by name."""
    m = Manifest()
    cell = m.workload(CELL)
    conf = _merge(m.config(cell["config"]), TINY["config"])
    traffic = _merge(m.traffic(cell["traffic"]), TINY["traffic"])
    preset, model_cfg = conf["preset"], conf["model"]
    H, W = traffic["image_hw"]
    focal = math.sqrt(W * W + H * H)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tensors = generate.body_model(model_cfg, SEED, "cpu")
        for k, v in tensors.items():
            out[f"model.{k}"] = _digest(v)
        paths = generate.write_model(tensors, tmp)
        body = ref.Body(paths["model"], {**model_cfg, "num_pca_comps":
                                         preset["num_pca_comps"]},
                        torch.float64, "cpu")
        gt = generate.ground_truth(traffic, 4, focal, SEED, "cpu",
                                   preset["num_pca_comps"], preset["num_betas"],
                                   preset["num_expression_coeffs"])
        for k, v in gt.items():
            out[f"truth.{k}"] = _digest(v)
        kp = generate.keypoints(body, gt, traffic, focal, (H, W), SEED, "cpu")
        out["keypoints"] = _digest(torch.as_tensor(kp))
        reg = generate.regression(gt, traffic, SEED, "cpu")
        for k, v in reg.items():
            out[f"regression.{k}"] = _digest(v)
        # The reference's energy and gradient at the truth's parameters,
        # the arms pressed into the body so that the collision term counts.
        x = torch.cat([gt["cam_t"], gt["global_orient"], gt["body_pose"],
                       gt["betas"], gt["expression"], gt["jaw_pose"],
                       gt["leye_pose"], gt["reye_pose"], gt["left_hand_pose"],
                       gt["right_hand_pose"]], 1)
        x[:, 6 + 47] -= 0.5
        x[:, 6 + 50] += 0.5
        x.requires_grad_(True)
        coll = ref.Collision(body.faces, paths["part_segm"], preset)
        e = ref.energy(body, preset, x, torch.as_tensor(kp), focal, (H, W),
                       coll, reg_body=reg["body_pose"])
        g, = torch.autograd.grad(e["total"].sum(), x)
        for k, v in e["terms"].items():
            out[f"energy.{k}"] = _digest(v)
        out["energy.grad"] = _digest(g)
    return out


# Recorded on the parent commit with `readings()`.
PARENT = {
    "energy.bending": [7991.811493151527, 251.4105949701052],
    "energy.collision": [208398797.702508, 25887635.9846619],
    "energy.data": [2594562.89537326, -59621.58819686307],
    "energy.expression": [195.99029592291694, 90.02267872993616],
    "energy.grad": [6565174545.874962, -16651842.203199267],
    "energy.hands": [80.09174125973063, 10.163116848215072],
    "energy.jaw": [23856.509400818002, 13654.281984161491],
    "energy.pose_prior": [188879.5976283562, -5532.79875197816],
    "energy.shape": [16304.523809119964, -1037.0602823490553],
    "keypoints": [411523.6130068004, -250.2177771959971],
    "model.J_regressor": [55.00000033112629, -0.41545714180459814],
    "model.dyn_lmk_bary_coords": [1342.9999916860834, -3.7130977754229377],
    "model.dyn_lmk_faces_idx": [851620.0, 755.2483799603265],
    "model.exprdirs": [3.189867689550738, -0.040494477288141026],
    "model.faces": [2948714.0, -19.969761499678953],
    "model.lbs_weights": [1000.0000015718178, 1.9092851096717585],
    "model.left_hand_components": [-13.860582042696478, 20.198856544274705],
    "model.left_hand_mean": [0.0, 0.0],
    "model.lmk_bary_coords": [51.00000031804666, 3.9641084827056234],
    "model.lmk_faces_idx": [34244.0, -1384.717923922894],
    "model.parents": [1201.0, -44.32248319196275],
    "model.posedirs": [1.5720276993185838, -0.004306680001398222],
    "model.right_hand_components": [4.754328518058173, -18.9909423345147],
    "model.right_hand_mean": [0.0, 0.0],
    "model.segm": [18015.0, 80.96209210231099],
    "model.segm_parents": [13326.0, 67.9230997234298],
    "model.shapedirs": [69.52304678866494, -0.24020039975542462],
    "model.v_template": [51.26601496312651, -2.024582699228775],
    "regression.body_pose": [2.4312342019632283, 8.907833599724183],
    "regression.cam_t": [17.46545049034198, -0.7663080258536957],
    "regression.global_orient": [0.35848518006549235, 0.5423362983103428],
    "truth.betas": [-0.42941876702890913, 1.7840108910360652],
    "truth.body_pose": [2.1489942249017613, 9.49939661240522],
    "truth.cam_t": [17.251440708801056, -0.6166345203722026],
    "truth.expression": [1.9230888537151887, 2.423766809505201],
    "truth.global_orient": [0.3338227966819874, -0.1766623359065607],
    "truth.jaw_pose": [0.0169042634123472, 0.18779764308373673],
    "truth.left_hand_pose": [-1.1109973906375616, -0.31973377143879206],
    "truth.leye_pose": [0.0, 0.0],
    "truth.reye_pose": [0.0, 0.0],
    "truth.right_hand_pose": [-0.3851820303326285, 1.2393285306465271],
}


@pytest.fixture(scope="module")
def got():
    return readings()


@pytest.mark.parametrize("name", sorted(PARENT))
def test_the_combined_path_reads_what_it_read_before(got, name):
    assert name in got
    for a, b in zip(got[name], PARENT[name]):
        assert a == pytest.approx(b, rel=REL, abs=1e-300), (name, a, b)


def test_every_reading_is_pinned(got):
    assert set(got) == set(PARENT)


def test_a_tiny_run_reads_correct_within_every_limit():
    m = Manifest()
    run = run_cell(m, m.workload(CELL), SEED, 0.0, False, device="cpu",
                   overrides=TINY)
    assert run["line"]["correct"], run["checks"]
    for name, c in run["checks"].items():
        assert c["value"] <= c["limit"], (name, c)
