"""The generators are deterministic in the seed, build the surface they
promise, and write the files the program reads."""

import tempfile

import numpy as np
import pytest
import torch

from perfbench import generate
from perfbench import reference as ref
from perfbench.manifest import Manifest

MODEL = {"num_verts": 300, "num_faces": 500, "num_betas": 10,
         "num_expression_coeffs": 10, "num_hand_components": 45}
SEED = 3_000_000_017        # past 2**31, as a run's seed may be


def _model(seed):
    return generate.body_model(MODEL, seed, "cpu")


def test_body_model_is_the_seeds():
    a, b, c = _model(SEED), _model(SEED), _model(SEED + 1)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["shapedirs"], c["shapedirs"])
    assert a["faces"].shape == (500, 3)
    assert torch.allclose(a["lbs_weights"].sum(1), torch.ones(300))
    # a face's corners are distinct vertices
    f = a["faces"]
    assert ((f[:, 0] != f[:, 1]) & (f[:, 0] != f[:, 2])
            & (f[:, 1] != f[:, 2])).all()


@pytest.mark.parametrize("V,F", [(10475, 20908), (400, 700), (300, 500)])
def test_the_surface_is_closed_but_for_the_mouth(V, F):
    """Exactly V vertices and F faces, every vertex in a face, and every
    edge shared by two faces except around the cut."""
    s = generate.surface(V, F)
    assert s["verts"].shape == (V, 3) and s["faces"].shape == (F, 3)
    assert np.array_equal(np.unique(s["faces"]), np.arange(V))
    e = np.sort(s["faces"][:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), 1)
    _, count = np.unique(e, axis=0, return_counts=True)
    assert count.max() == 2
    assert (count == 1).sum() <= 3 * (2 * V - 20 - F)


def test_the_vertex_joints_sit_where_they_are_named():
    s = generate.surface(10475, 20908)
    spots = np.asarray(generate.VERTEX_JOINT_SPOTS)
    got = s["verts"][ref.SMPLX_EXTRA_JOINT_VIDS]
    assert np.linalg.norm(got - spots, axis=1).max() < 0.03


def test_no_part_touches_another_that_is_scored_in_the_rest_pose():
    """At the rest pose the part filter drops every overlap, so the
    collision term scores only what a pose brings into contact."""
    conf = Manifest().config("smplx-combined-coco25")
    m = generate.body_model({**MODEL, "num_verts": 2000, "num_faces": 3900},
                            SEED, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        paths = generate.write_model(m, tmp)
        coll = ref.Collision(m["faces"], paths["part_segm"], conf["preset"])
    assert len(coll.pairs(m["v_template"].double())) == 0


def test_frames_are_the_seeds():
    traffic = Manifest().traffic("offline-b128")
    with tempfile.TemporaryDirectory() as tmp:
        paths = generate.write_model(_model(SEED), tmp)
        body = ref.Body(paths["model"], {**MODEL, "num_pca_comps": 12},
                        torch.float64, "cpu")
        kps, regs = [], []
        for _ in range(2):
            gt = generate.ground_truth(traffic, 3, 1000.0, SEED, "cpu",
                                       12, 10, 10)
            kps.append(generate.keypoints(body, gt, traffic, 1000.0,
                                          traffic["image_hw"], SEED, "cpu"))
            regs.append(generate.regression(gt, traffic, SEED, "cpu"))
    assert np.array_equal(kps[0], kps[1])
    assert all(torch.equal(regs[0][k], regs[1][k]) for k in regs[0])
    assert kps[0].shape == (3, 135, 3)
    lo, hi = traffic["confidence"]
    assert (kps[0][..., 2] >= lo).all() and (kps[0][..., 2] <= hi).all()
    # each body's keypoints centre inside the image
    H, W = traffic["image_hw"]
    mid = kps[0][..., :2].mean(1)
    assert ((mid > 0) & (mid < [W, H])).all()
    # the regressors' estimates lie near the truth
    assert (regs[0]["body_pose"] - gt["body_pose"]).abs().max() < 1.0
    assert ((regs[0]["cam_t"][:, 2] / gt["cam_t"][:, 2] - 1).abs() < 0.6).all()


def test_written_model_loads_in_the_program():
    from smplifyx_torch.models.bodymodel import load_body_model

    m = _model(SEED)
    with tempfile.TemporaryDirectory() as tmp:
        paths = generate.write_model(m, tmp)
        loaded = load_body_model(paths["model"], "smplx", device="cpu")
    assert torch.equal(loaded.v_template, m["v_template"])
    assert torch.equal(loaded.faces, m["faces"])
    assert torch.allclose(loaded.posedirs, m["posedirs"])
