"""A VPoser override of the combined cell: the published combined VPoser
preset (xiyichen/smplify-x-partial, fit_smplx_combined_vposer_coco25.yaml:
`use_vposer`, body-pose prior weights 20/10/7.5) over the combined one,
a VPoser v1 of the published widths (32-d latent, 512 hidden units) whose
decoder gives the arms-lowered pose at z = 0, and the truth drawn as
decoded latents of 1.45 per component, which spread the decoded poses by
about 0.12 rad per component about that pose, as the combined traffic's
are.  `VPOSER` is at the cell's own size; `TINY_VPOSER` at the tests'."""

from perfbench.cell import _merge
from perfbench.tests._tiny import TINY

ARMS_LOWERED = [[47, -1.3], [50, 1.3], [52, -0.3], [55, 0.3]]
VPOSER = {"config": {"preset": {"use_vposer": True, "vposer_latent_dim": 32,
                                "body_pose_prior_weights": [20.0, 10.0, 7.5]},
                     "vposer": {"hidden": 512, "mean_pose": ARMS_LOWERED}},
          "traffic": {"vposer_latent_std": 1.45}}
TINY_VPOSER = _merge(TINY, VPOSER)
