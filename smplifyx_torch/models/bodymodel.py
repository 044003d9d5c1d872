"""SMPL-X body model data: structure, the npz loader and synthetic models.

Counterpart of `smplifyx_tpu/models/bodymodel.py`.  The model is a
dataclass of tensors consumed by the plain forward function in
models/forward.py.  The synthetic generators draw from numpy's
`default_rng(seed)` in the same order as the JAX package, so both packages
build identical arrays from one seed.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from smplifyx_torch.utils.device import resolve_device
from smplifyx_torch.utils.tensors import TensorFields

SHAPE_SPACE_DIM = 300  # shape columns before the expression block

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 20, 21],
    dtype=np.int32,
)
SMPLH_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
     20, 22, 23, 20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35,   # left hand
     21, 37, 38, 21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50],  # right hand
    dtype=np.int32,
)
SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
     15, 15, 15,  # 22 jaw, 23 leye, 24 reye
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,  # left hand
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],  # right hand
    dtype=np.int32,
)

# Vertex ids of the 21 extra "vertex joints" appended after the skeleton
# joints (nose/eyes/ears, toes/heels, finger tips), per family.
SMPLX_EXTRA_JOINT_VIDS = np.array(
    [9120, 9929, 9448, 616, 6,
     5770, 5780, 8846, 8463, 8474, 8635,
     5361, 4933, 5058, 5169, 5286,
     8079, 7669, 7794, 7905, 8022],
    dtype=np.int32,
)
SMPLH_EXTRA_JOINT_VIDS = np.array(
    [332, 6260, 2800, 4071, 583,
     3216, 3226, 3387, 6617, 6624, 6740,
     2746, 2319, 2445, 2556, 2673,
     6191, 5782, 5905, 6016, 6133],
    dtype=np.int32,
)
SMPL_EXTRA_JOINT_VIDS = SMPLH_EXTRA_JOINT_VIDS[:11]


@dataclass
class SMPLXModel(TensorFields):
    """SMPL-X model tensors.

    V = #vertices, J = #skeleton joints, F = #faces, K = #shape coeffs,
    E = #expression coeffs, C = #hand PCA comps, P = (J - 1) * 9.
    Index tensors are int64.
    """

    v_template: torch.Tensor        # [V, 3]
    shapedirs: torch.Tensor         # [V, 3, K]
    exprdirs: torch.Tensor          # [V, 3, E]
    posedirs: torch.Tensor          # [P, V * 3]
    J_regressor: torch.Tensor       # [J, V]
    lbs_weights: torch.Tensor       # [V, J]
    faces: torch.Tensor             # [F, 3]
    left_hand_components: torch.Tensor   # [C, 45]
    right_hand_components: torch.Tensor  # [C, 45]
    left_hand_mean: torch.Tensor    # [45]
    right_hand_mean: torch.Tensor   # [45]
    extra_joint_vids: torch.Tensor  # [21]
    lmk_faces_idx: torch.Tensor     # [51] static face landmarks
    lmk_bary_coords: torch.Tensor   # [51, 3]
    dyn_lmk_faces_idx: torch.Tensor    # [L, 17] contour faces per yaw bucket
    dyn_lmk_bary_coords: torch.Tensor  # [L, 17, 3]
    parents: tuple                  # static kinematic tree
    num_verts: int
    num_joints: int
    neck_kin_chain: tuple

    @property
    def num_betas(self) -> int:
        return self.shapedirs.shape[-1]

    @property
    def num_expr(self) -> int:
        return self.exprdirs.shape[-1]

    @property
    def num_pca(self) -> int:
        return self.left_hand_components.shape[0]


_INDEX_FIELDS = ("faces", "extra_joint_vids", "lmk_faces_idx",
                 "dyn_lmk_faces_idx")


def model_from_arrays(arrays: dict, parents, device="cuda") -> SMPLXModel:
    """SMPLXModel from numpy arrays keyed by field name (extra keys, such as
    the JAX package's extra_lmk_matrix, are ignored)."""
    dev = resolve_device(device)
    parents = tuple(int(p) for p in parents)
    kw = {}
    for f in dataclasses.fields(SMPLXModel):
        if f.name in ("parents", "num_verts", "num_joints", "neck_kin_chain"):
            continue
        a = np.asarray(arrays[f.name])
        dtype = torch.int64 if f.name in _INDEX_FIELDS else torch.float32
        kw[f.name] = torch.as_tensor(
            a.astype(np.int64 if dtype == torch.int64 else np.float32)
        ).to(dev)
    return SMPLXModel(
        **kw, parents=parents, num_verts=int(kw["v_template"].shape[0]),
        num_joints=len(parents), neck_kin_chain=_neck_kin_chain(parents),
    )


def _neck_kin_chain(parents, head_idx: int = 15) -> tuple:
    """Ancestor chain from the head joint to the root, used to aggregate the
    head yaw for dynamic (contour) landmark selection."""
    chain = []
    idx = head_idx
    while idx != -1 and len(chain) < len(parents):
        chain.append(idx)
        idx = int(parents[idx])
    return tuple(chain)


def load_body_model(
    path: str,
    model_type: str = "smplx",
    num_betas: int = 10,
    num_expression_coeffs: int = 10,
    num_pca_comps: int = 12,
    device="cuda",
) -> SMPLXModel:
    """Load a body-model .npz artifact (SMPL-X, SMPL-H or SMPL layout).

    Field conventions follow the published layouts, as in the JAX
    package's loader.  Legacy .pkl artifacts are not read by the port yet.
    """
    if not path.endswith(".npz"):
        raise NotImplementedError(
            f"{path}: the port reads .npz body models only (the .pkl loader "
            "is a later port item, ROADMAP queue 1 item 3)"
        )
    raw = np.load(path, allow_pickle=True)
    d = {k: raw[k] for k in raw.files}
    has_face = model_type == "smplx"
    has_hands = model_type in ("smplx", "smplh")

    shapedirs_all = np.asarray(d["shapedirs"], dtype=np.float32)
    shape_cols = shapedirs_all[..., :num_betas]
    if shapedirs_all.shape[-1] > SHAPE_SPACE_DIM:  # shape+expression packed
        expr_cols = shapedirs_all[
            ..., SHAPE_SPACE_DIM:SHAPE_SPACE_DIM + num_expression_coeffs]
    elif "exprdirs" in d:
        expr_cols = np.asarray(d["exprdirs"], np.float32)[
            ..., :num_expression_coeffs]
    else:
        expr_cols = np.zeros((*shape_cols.shape[:2], num_expression_coeffs),
                             np.float32)

    posedirs = np.asarray(d["posedirs"], dtype=np.float32)
    V = posedirs.shape[0]
    posedirs = posedirs.reshape(V * 3, -1).T

    parents = np.asarray(d["kintree_table"][0], dtype=np.int64).copy()
    parents[0] = -1

    def arr(key):
        return np.asarray(d[key], np.float32)

    if has_hands and "hands_componentsl" in d:
        hands = dict(
            left_hand_components=arr("hands_componentsl")[:num_pca_comps],
            right_hand_components=arr("hands_componentsr")[:num_pca_comps],
            left_hand_mean=arr("hands_meanl"),
            right_hand_mean=arr("hands_meanr"),
        )
    else:
        hands = dict(
            left_hand_components=np.zeros((num_pca_comps, 45), np.float32),
            right_hand_components=np.zeros((num_pca_comps, 45), np.float32),
            left_hand_mean=np.zeros(45, np.float32),
            right_hand_mean=np.zeros(45, np.float32),
        )
    extra_vids = {"smplx": SMPLX_EXTRA_JOINT_VIDS,
                  "smplh": SMPLH_EXTRA_JOINT_VIDS,
                  "smpl": SMPL_EXTRA_JOINT_VIDS}[model_type]
    if has_face:
        face = dict(
            lmk_faces_idx=d["lmk_faces_idx"],
            lmk_bary_coords=arr("lmk_bary_coords"),
            dyn_lmk_faces_idx=d["dynamic_lmk_faces_idx"],
            dyn_lmk_bary_coords=arr("dynamic_lmk_bary_coords"),
        )
    else:
        face = dict(
            lmk_faces_idx=np.zeros((0,), np.int64),
            lmk_bary_coords=np.zeros((0, 3), np.float32),
            dyn_lmk_faces_idx=np.zeros((1, 0), np.int64),
            dyn_lmk_bary_coords=np.zeros((1, 0, 3), np.float32),
        )
    return model_from_arrays(dict(
        v_template=arr("v_template"), shapedirs=shape_cols,
        exprdirs=expr_cols, posedirs=posedirs,
        J_regressor=np.asarray(d["J_regressor"], np.float32),
        lbs_weights=arr("weights"), faces=d["f"],
        extra_joint_vids=np.minimum(extra_vids, V - 1),
        **hands, **face,
    ), parents, device)


def _synthetic_arrays(num_verts, num_betas, num_expression_coeffs,
                      num_pca_comps, seed, model_type):
    """numpy arrays of `synthetic_model`, in the JAX package's RNG order."""
    rng = np.random.default_rng(seed)
    V = num_verts
    parents_np = {"smplx": SMPLX_PARENTS, "smplh": SMPLH_PARENTS,
                  "smpl": SMPL_PARENTS}[model_type]
    J = len(parents_np)
    has_face = model_type == "smplx"

    v_template = rng.normal(scale=0.25, size=(V, 3)).astype(np.float32)
    v_template[:, 1] *= 2.0
    shapedirs = rng.normal(scale=0.01, size=(V, 3, num_betas)).astype(np.float32)
    exprdirs = rng.normal(scale=0.003, size=(V, 3, num_expression_coeffs)
                          ).astype(np.float32)
    posedirs = rng.normal(scale=0.001, size=((J - 1) * 9, V * 3)).astype(np.float32)

    J_regressor = np.zeros((J, V), dtype=np.float32)
    for j in range(J):
        sel = rng.choice(V, size=min(8, V), replace=False)
        w = rng.uniform(0.1, 1.0, size=len(sel)).astype(np.float32)
        J_regressor[j, sel] = w / w.sum()

    lbs = np.zeros((V, J), dtype=np.float32)
    for v in range(V):
        sel = rng.choice(J, size=4, replace=False)
        w = rng.uniform(0.1, 1.0, size=4).astype(np.float32)
        lbs[v, sel] = w / w.sum()

    num_faces = max(4, V // 2)
    faces = rng.integers(0, V, size=(num_faces, 3)).astype(np.int32)

    hand_comp_l = rng.normal(scale=0.5, size=(num_pca_comps, 45)).astype(np.float32)
    hand_comp_r = rng.normal(scale=0.5, size=(num_pca_comps, 45)).astype(np.float32)
    hand_mean = rng.normal(scale=0.1, size=(2, 45)).astype(np.float32)

    n_extras = 21 if model_type in ("smplx", "smplh") else 11
    extra_vids = rng.choice(V, size=n_extras, replace=V < n_extras)
    n_lmk = 51 if has_face else 0
    lmk_faces = rng.integers(0, num_faces, size=(n_lmk,)).astype(np.int32)
    lmk_bary = (rng.dirichlet(np.ones(3), size=(n_lmk,)).astype(np.float32)
                if n_lmk else np.zeros((0, 3), np.float32))
    L = 79 if has_face else 1
    # One contour table tiled over all yaw buckets: the energy stays
    # continuous in head yaw (see the JAX package's note).
    n_dyn = 17 if has_face else 0
    dyn_faces = np.tile(
        rng.integers(0, num_faces, size=(1, n_dyn)).astype(np.int32), (L, 1))
    dyn_bary = np.tile(
        rng.dirichlet(np.ones(3), size=(1, n_dyn)).astype(np.float32)
        if n_dyn else np.zeros((1, 0, 3), np.float32),
        (L, 1, 1),
    )
    arrays = dict(
        v_template=v_template, shapedirs=shapedirs, exprdirs=exprdirs,
        posedirs=posedirs, J_regressor=J_regressor, lbs_weights=lbs,
        faces=faces, left_hand_components=hand_comp_l,
        right_hand_components=hand_comp_r, left_hand_mean=hand_mean[0],
        right_hand_mean=hand_mean[1], extra_joint_vids=extra_vids,
        lmk_faces_idx=lmk_faces, lmk_bary_coords=lmk_bary,
        dyn_lmk_faces_idx=dyn_faces, dyn_lmk_bary_coords=dyn_bary,
    )
    return arrays, parents_np


def synthetic_model(
    num_verts: int = 256,
    num_betas: int = 10,
    num_expression_coeffs: int = 10,
    num_pca_comps: int = 12,
    seed: int = 0,
    model_type: str = "smplx",
    device="cuda",
) -> SMPLXModel:
    """Structurally complete synthetic body model with `num_verts` random
    vertices (same kinematic tree, hand PCA space and landmark tables as
    the real artifacts), identical to the JAX package's for one seed."""
    arrays, parents = _synthetic_arrays(num_verts, num_betas,
                                        num_expression_coeffs, num_pca_comps,
                                        seed, model_type)
    return model_from_arrays(arrays, parents, device)


def smooth_synthetic_model(
    num_verts: int = 512,
    num_betas: int = 10,
    num_expression_coeffs: int = 10,
    num_pca_comps: int = 12,
    seed: int = 0,
    device="cuda",
) -> SMPLXModel:
    """Synthetic SMPL-X with a smooth, identifiable geometry (capsules
    around a human-proportioned skeleton, smooth skinning, affine shape
    space), identical to the JAX package's for one seed."""
    rng = np.random.default_rng(seed)
    V = num_verts
    parents = tuple(int(v) for v in SMPLX_PARENTS)
    J = len(parents)

    joints = np.zeros((J, 3), np.float32)
    base = {
        0: (0, 0, 0), 3: (0, 0.12, 0), 6: (0, 0.25, 0), 9: (0, 0.38, 0),
        12: (0, 0.50, 0), 15: (0, 0.60, 0), 22: (0, 0.58, 0.05),
        23: (0.03, 0.62, 0.08), 24: (-0.03, 0.62, 0.08),
        13: (0.08, 0.45, 0), 14: (-0.08, 0.45, 0),
        16: (0.18, 0.47, 0), 17: (-0.18, 0.47, 0),
        18: (0.42, 0.46, 0), 19: (-0.42, 0.46, 0),
        20: (0.66, 0.45, 0), 21: (-0.66, 0.45, 0),
        1: (0.09, -0.05, 0), 2: (-0.09, -0.05, 0),
        4: (0.10, -0.45, 0), 5: (-0.10, -0.45, 0),
        7: (0.11, -0.85, 0), 8: (-0.11, -0.85, 0),
        10: (0.11, -0.92, 0.10), 11: (-0.11, -0.92, 0.10),
    }
    for j, p in base.items():
        joints[j] = p
    for j in range(25, J):
        par = parents[j]
        sign = 1.0 if j < 40 else -1.0
        if par in (20, 21):
            k = (j - 25) % 15 // 3
            joints[j] = joints[par] + np.array(
                [sign * 0.04, 0.0, (k - 2) * 0.015], np.float32)
        else:
            joints[j] = joints[par] + np.array([sign * 0.03, 0.0, 0.0],
                                               np.float32)

    bone_children = [j for j in range(1, J)]
    seg_par = np.array([parents[j] for j in bone_children])
    seg_child = np.array(bone_children)
    weights_seg = np.where(seg_child < 25, 8.0, 1.0)
    probs = weights_seg / weights_seg.sum()
    seg_idx = rng.choice(len(bone_children), size=V, p=probs)
    t = rng.uniform(0, 1, (V, 1)).astype(np.float32)
    a = joints[seg_par[seg_idx]]
    b = joints[seg_child[seg_idx]]
    radius = np.where(seg_child[seg_idx] < 25, 0.06, 0.012)[:, None]
    normal = rng.normal(size=(V, 3)).astype(np.float32)
    normal /= np.linalg.norm(normal, axis=1, keepdims=True) + 1e-9
    v_template = (a + t * (b - a) + radius * normal).astype(np.float32)

    d2 = ((v_template[:, None, :] - joints[None, :, :]) ** 2).sum(-1)
    near = np.argsort(d2, axis=1)[:, :4]
    lbs = np.zeros((V, J), np.float32)
    rows = np.arange(V)[:, None]
    w = np.exp(-d2[rows, near] / 0.02)
    w /= w.sum(axis=1, keepdims=True) + 1e-12
    lbs[rows, near] = w

    J_regressor = np.zeros((J, V), np.float32)
    nearv = np.argsort(d2.T, axis=1)[:, :8]
    jw = np.exp(-d2.T[np.arange(J)[:, None], nearv] / 0.01)
    jw /= jw.sum(axis=1, keepdims=True) + 1e-12
    J_regressor[np.arange(J)[:, None], nearv] = jw

    def affine_dirs(n, scale):
        A = rng.normal(scale=scale, size=(n, 3, 3)).astype(np.float32)
        bvec = rng.normal(scale=scale * 0.5, size=(n, 3)).astype(np.float32)
        D = np.einsum("kcd,vd->vck", A, v_template) + bvec.T[None]
        return D.astype(np.float32)

    shapedirs = affine_dirs(num_betas, 0.03)
    exprdirs = affine_dirs(num_expression_coeffs, 0.005)
    posedirs = affine_dirs((J - 1) * 9, 1.5e-4).reshape(V * 3, -1).T

    num_faces = max(4, V // 2)
    f0 = rng.integers(0, V, size=num_faces)
    order = np.argsort(v_template[:, 1])
    rank = np.empty(V, np.int64)
    rank[order] = np.arange(V)

    def near_pick(base_idx, k):
        step = rng.integers(1, 6, size=len(base_idx)) * k
        return order[np.clip(rank[base_idx] + step, 0, V - 1)]

    faces = np.stack([f0, near_pick(f0, 1), near_pick(f0, -1)], axis=1)

    hand_comp_l = rng.normal(scale=0.4, size=(num_pca_comps, 45)).astype(np.float32)
    hand_comp_r = rng.normal(scale=0.4, size=(num_pca_comps, 45)).astype(np.float32)
    extra_vids = rng.choice(V, size=21, replace=V < 21)
    lmk_faces = rng.integers(0, num_faces, size=(51,))
    lmk_bary = rng.dirichlet(np.ones(3), size=(51,)).astype(np.float32)
    dyn_faces = np.tile(rng.integers(0, num_faces, size=(1, 17)), (79, 1))
    dyn_bary = np.tile(
        rng.dirichlet(np.ones(3), size=(1, 17)).astype(np.float32), (79, 1, 1))
    return model_from_arrays(dict(
        v_template=v_template, shapedirs=shapedirs, exprdirs=exprdirs,
        posedirs=posedirs, J_regressor=J_regressor, lbs_weights=lbs,
        faces=faces, left_hand_components=hand_comp_l,
        right_hand_components=hand_comp_r,
        left_hand_mean=np.zeros(45, np.float32),
        right_hand_mean=np.zeros(45, np.float32),
        extra_joint_vids=extra_vids, lmk_faces_idx=lmk_faces,
        lmk_bary_coords=lmk_bary, dyn_lmk_faces_idx=dyn_faces,
        dyn_lmk_bary_coords=dyn_bary,
    ), parents, device)
