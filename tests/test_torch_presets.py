"""The classic SMPLify-X preset and the Halpe preset through `app.run` in
both packages, on the CPU, with the collision term on.

One generated data folder (`problem.write_app_inputs`: V=96, two frames,
the folder's own model and part segmentation read from its files by both
packages), `maxiters` 2.  Every frame's final loss must agree with JAX's
within 5% and the output trees must match (`tests/_torch_parity.py::
held_to_jax`).

  * `cfg/fit_smplx_smplifyx.yaml` (BASELINE config #1): five body stages,
    the collision term in stages 3-4 at weights 0.01 and 1.0, VPoser from
    the zero latent with no regression prior, the camera initialised
    without confidences and no camera prior, focal length 5000, 3-vector
    jaw prior weights; on two frames and on one, the reference's unit of
    work (one image per process);
  * `cfg/fit_smplx_combined_halpe.yaml` (BASELINE config #3): Halpe-26 body
    keypoints, its joint map, ignored joints, torso edges and camera-init
    joints; collision off and on."""

import numpy as np
import pytest

from smplifyx_torch.app import run
from smplifyx_torch.models.joint_mapping import model_to_annotation
from smplifyx_torch.problem import write_app_inputs
from smplifyx_torch.utils.config import load_config

from tests._torch_parity import (
    PRESETS,
    halpe_folder,
    held_to_jax,
    run_both,
    torch_threads,
)

V, FRAMES = 96, 2


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("presets")
    return write_app_inputs(str(root), batch=FRAMES, num_verts=V)


def test_classic_preset_is_the_five_stage_schedule(folder):
    """What the parity cases below run: five body stages, the collision
    term only in the last two, no regression or camera prior."""
    cfg = load_config(PRESETS["smplifyx"], **folder.overrides)
    assert cfg.interpenetration and cfg.use_vposer
    assert cfg.coll_loss_weights == [0.0, 0.0, 0.0, 0.01, 1.0]
    assert len(cfg.body_pose_prior_weights) == 5
    assert not (cfg.regression_prior or cfg.use_camera_prior
                or cfg.use_conf_for_camera_init)
    assert cfg.focal_length == 5000


@pytest.mark.parametrize("frames", [FRAMES, 1])
def test_classic_preset_matches_jax_collision_on(folder, tmp_path, frames):
    jres, tres, outs = run_both("smplifyx", str(tmp_path / "out"),
                                max_frames=frames, **folder.overrides)
    held_to_jax(jres, tres, outs)
    assert tres.names == folder.names[:frames]
    assert len(tres.stats["stage_evals_max"]) == 5


@pytest.mark.parametrize("interpenetration", [False, True])
def test_halpe_preset_matches_jax(folder, tmp_path, interpenetration):
    data = halpe_folder(folder.overrides["data_folder"],
                        str(tmp_path / "halpe"))
    over = dict(folder.overrides, data_folder=data,
                interpenetration=interpenetration)
    jres, tres, outs = run_both("combined_halpe", str(tmp_path / "out"),
                                **over)
    held_to_jax(jres, tres, outs)
    assert tres.names == folder.names


def test_halpe_inputs_project_the_halpe_joints(tmp_path):
    """`write_app_inputs(..., keypoint_format="halpe")` writes 26 body
    keypoints per person: the same model joints as the coco25 files where
    both formats name one, projected alike."""
    coco = write_app_inputs(str(tmp_path / "coco"), batch=FRAMES, num_verts=V)
    halpe = write_app_inputs(str(tmp_path / "halpe"), batch=FRAMES,
                             num_verts=V, keypoint_format="halpe")
    cmap = model_to_annotation("smplx", True, True, True, "coco25")
    hmap = model_to_annotation("smplx", True, True, True, "halpe")
    assert halpe.frames.gt_joints.shape[1] == len(hmap) == len(cmap) + 1
    shared = 0
    for h, joint in enumerate(hmap):
        same = np.flatnonzero(cmap == joint)
        if len(same):
            shared += 1
            np.testing.assert_allclose(halpe.frames.gt_joints[:, h].numpy(),
                                       coco.frames.gt_joints[:, same[0]].numpy(),
                                       rtol=0, atol=1e-4)
    assert shared == len(hmap) - 1      # the head (Halpe 17) is Halpe's own
    cfg = load_config(PRESETS["combined_halpe"], **halpe.overrides,
                      output_folder=str(tmp_path / "out"), maxiters=1,
                      interactive=False)
    with torch_threads(1):
        res = run(cfg, device="cpu")
    assert res.names == halpe.names and np.isfinite(res.losses).all()
