"""Configuration system: dataclass + YAML presets.

The port's own copy of the JAX package's `utils/config.py` (field names,
defaults and profile resolution are identical, so every preset in cfg/
loads into the same values).  `parse_cli` and `save_config` wait for the
port's CLI.
The `platform` field is accepted so presets still load; the port ignores
it (entry points take `device=` instead).

Replaces the reference's configargparse setup (smplifyx/cmd_parser.py:27-317,
~70 flags with YAML config files).  Field names and semantics match the
reference so its cfg_files port directly; the four shipped presets live in
cfg/ and mirror the reference's cfg_files/ semantics (stage counts are
implied by the weight-list lengths, jaw weights are comma-separated
3-vectors, body_tri_idxs flat list becomes pairs).
"""

from __future__ import annotations

import dataclasses
import os.path as osp
from dataclasses import dataclass, field
from typing import Any, List, Optional

import yaml


@dataclass
class Config:
    data_folder: str = "data"
    img_folder: str = "images"
    keyp_folder: str = "keypoints"
    output_folder: str = "output"
    result_folder: str = "results"
    mesh_folder: str = "meshes"
    model_folder: str = "models"
    prior_folder: str = "prior"
    summary_folder: str = "summaries"
    vposer_ckpt: str = ""
    part_segm_fn: str = ""

    format: str = "coco25"
    model_type: str = "smplx"
    gender: str = "neutral"
    float_dtype: str = "float32"
    num_betas: int = 10
    num_expression_coeffs: int = 10
    num_pca_comps: int = 12
    use_pca: bool = True
    flat_hand_mean: bool = False
    use_hands: bool = True
    use_face: bool = True
    use_face_contour: bool = False
    joints_to_ign: List[int] = field(default_factory=lambda: [-1])

    body_prior_type: str = "l2"
    left_hand_prior_type: str = "l2"
    right_hand_prior_type: str = "l2"
    jaw_prior_type: str = "l2"
    num_gaussians: int = 8
    use_vposer: bool = False
    vposer_latent_dim: int = 32

    regression_prior: Optional[str] = None
    pixie_results_directory: Optional[str] = None
    expose_results_directory: Optional[str] = None
    pare_results_directory: Optional[str] = None
    use_camera_prior: bool = False

    rho: float = 100.0
    use_joints_conf: bool = True
    use_conf_for_camera_init: bool = False
    confidence_threshold: float = 0.0
    interpenetration: bool = False
    df_cone_height: float = 0.5
    penalize_outside: bool = False
    max_collisions: int = 8
    collision_window: int = 640
    max_coll_pairs: int = 4096
    coll_broad_every: Optional[int] = None
    profile: str = "fast"
    ls_mode: Optional[str] = None
    max_evals: Optional[int] = None
    ls_soft_accept: Optional[int] = None
    point2plane: bool = False
    ign_part_pairs: List[str] = field(default_factory=list)

    platform: Optional[str] = None   # accepted so presets load; unused

    focal_length: Optional[float] = None
    camera_type: str = "persp"
    depth_loss_weight: float = 1e2
    init_joints_idxs: List[int] = field(default_factory=lambda: [9, 12, 2, 5])
    body_tri_idxs: List[int] = field(default_factory=lambda: [5, 12, 2, 9])
    side_view_thsh: float = 25.0
    try_both_orient: bool = True

    data_weights: Optional[List[float]] = None
    body_pose_prior_weights: List[float] = field(
        default_factory=lambda: [404.0, 404.0, 57.4, 4.78]
    )
    shape_weights: Optional[List[float]] = None
    expr_weights: Optional[List[float]] = None
    hand_pose_prior_weights: Optional[List[float]] = None
    jaw_pose_prior_weights: Optional[List[Any]] = None
    hand_joints_weights: Optional[List[float]] = None
    face_joints_weights: Optional[List[float]] = None
    coll_loss_weights: Optional[List[float]] = None

    optim_shape: bool = True
    optim_expression: bool = True
    optim_jaw: bool = True
    optim_hands: bool = True
    loss_type: str = "smplify"

    optim_type: str = "lbfgsls"
    lr: float = 1.0
    ftol: float = 1e-9
    gtol: float = 1e-9
    maxiters: int = 30
    lbfgs_iters_per_stage: Optional[int] = None
    history_size: int = 16
    max_line_search: Optional[int] = None

    batch_size: int = 1
    interactive: bool = True
    visualize: bool = False
    save_meshes: bool = True
    save_vertices: bool = False
    use_gender_classifier: bool = False
    homogeneous_ckpt: str = ""
    max_persons: int = 3
    fit_all_persons: bool = False
    degrees: List[float] = field(default_factory=lambda: [0, 90, 180, 270])
    synthetic_model: bool = False
    synthetic_num_verts: int = 10475
    resume_from: Optional[str] = None

    @property
    def num_stages(self) -> int:
        return len(self.body_pose_prior_weights)

    @property
    def resolved_ls_mode(self) -> str:
        if self.ls_mode is not None:
            return self.ls_mode
        return "armijo" if self.profile == "fast" else "wolfe"

    @property
    def resolved_lbfgs_iters(self) -> int:
        """Flat per-stage L-BFGS iteration budget: maxiters x 2 under the
        fast profile, x 5 under reference."""
        if self.lbfgs_iters_per_stage:
            return self.lbfgs_iters_per_stage
        return self.maxiters * (2 if self.profile == "fast" else 5)

    @property
    def resolved_max_evals(self) -> int:
        if self.max_evals is not None:
            return self.max_evals
        if self.profile == "fast":
            return (3 * self.resolved_lbfgs_iters) // 2
        return 0

    @property
    def resolved_coll_broad_every(self) -> int:
        if self.coll_broad_every is not None:
            return self.coll_broad_every
        return 12 if self.profile == "fast" else 1

    @property
    def resolved_max_line_search(self) -> int:
        if self.max_line_search is not None:
            return self.max_line_search
        return 4 if self.profile == "fast" else 25

    @property
    def resolved_ls_soft_accept(self) -> Optional[int]:
        """None => LBFGSConfig keeps its own (effectively-off) default."""
        if self.ls_soft_accept is not None:
            return self.ls_soft_accept
        return 6 if self.profile == "fast" else None

    @property
    def body_tri_pairs(self) -> list[tuple[int, int]]:
        """Flat index list -> pairs (reference cmd_parser.py:307-316)."""
        flat = self.body_tri_idxs
        assert len(flat) % 2 == 0, (
            "Number of body_tri_idxs must be divisible by 2, got "
            f"{len(flat)}"
        )
        return [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]

    def validate(self) -> "Config":
        S = self.num_stages
        for name in ("data_weights", "shape_weights", "expr_weights",
                     "hand_pose_prior_weights", "jaw_pose_prior_weights",
                     "hand_joints_weights", "face_joints_weights",
                     "coll_loss_weights"):
            v = getattr(self, name)
            if v is not None and len(v) != S:
                raise ValueError(
                    f"{name} has {len(v)} entries but there are {S} stages "
                    "(stage count is the length of body_pose_prior_weights)"
                )
        if self.format.lower() not in ("coco25", "coco19", "halpe",
                                       "coco_wholebody"):
            raise ValueError(f"Unknown format {self.format}")
        if self.profile.lower() not in ("fast", "reference"):
            raise ValueError(
                f"Unknown profile {self.profile} (fast | reference)"
            )
        if (self.ls_mode is not None
                and self.ls_mode.lower() not in ("wolfe", "armijo")):
            raise ValueError(f"Unknown ls_mode {self.ls_mode}")
        if self.loss_type.lower() != "smplify":
            raise ValueError(
                f"Unknown loss type: {self.loss_type} (the reference's "
                "other value, 'camera_init', is the built-in stage-0 "
                "energy, not a run mode)"
            )
        return self


def load_config(path: Optional[str] = None, **overrides) -> Config:
    """Load a YAML preset, apply keyword overrides, validate."""
    values: dict = {}
    if path is not None:
        with open(osp.expandvars(path)) as f:
            raw = yaml.safe_load(f) or {}
        known = {f.name for f in dataclasses.fields(Config)}
        values = {k: v for k, v in raw.items() if k in known}
        unknown = set(raw) - known
        if unknown:
            import warnings

            warnings.warn(f"ignoring unknown config keys: {sorted(unknown)}")
    values.update(overrides)
    return Config(**values).validate()
