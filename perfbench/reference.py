"""The plain reference: SMPL-X forward, pinhole projection, VPoser v1's
decoder and encoder, the SMPLify energy of a stage with its exact
self-collision term, and Procrustes-aligned vertex error, in plain
PyTorch.

It imports nothing of the program under test.  It reads the same files the
program reads (the SMPL-X .npz, the part segmentation, the VPoser
state_dict) and the configuration's own numbers, and works out again
whatever the program derives from them: the joint map, the flat parameter
layout, the stage weights, the latent the regressor's pose encodes to,
the part filter and the collision pairs.  Every product
runs in the dtype a `Body` is built with; float64 is the yardstick, and
float32 with TF32 matmuls (`tf32=True`) is the control: the precision one
step below the configuration's float32 with TF32 off.
"""

from __future__ import annotations

import contextlib
import math
import pickle

import numpy as np
import torch

SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19,
     15, 15, 15,
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
    dtype=np.int64,
)
# SMPL-X's published vertex ids of the 21 vertex joints (nose, eyes, ears,
# toes and heels, finger tips).
SMPLX_EXTRA_JOINT_VIDS = np.array(
    [9120, 9929, 9448, 616, 6, 5770, 5780, 8846, 8463, 8474, 8635,
     5361, 4933, 5058, 5169, 5286, 8079, 7669, 7794, 7905, 8022])
# OpenPose coco25 keypoints with hands, face and contour, as rows of the
# canonical SMPL-X joints (55 skeleton, 21 vertex joints, 51 face, 17
# contour): the public OpenPose <-> SMPL-X correspondence.
COCO25_BODY = [55, 12, 17, 19, 21, 16, 18, 20, 0, 2, 5, 8, 1, 4, 7,
               56, 57, 58, 59, 60, 61, 62, 63, 64, 65]
LEFT_HAND = [20, 37, 38, 39, 66, 25, 26, 27, 67, 28, 29, 30, 68,
             34, 35, 36, 69, 31, 32, 33, 70]
RIGHT_HAND = [21, 52, 53, 54, 71, 40, 41, 42, 72, 43, 44, 45, 73,
              49, 50, 51, 74, 46, 47, 48, 75]
NECK_CHAIN = (15, 12, 9, 6, 3, 0)      # head to root
# Elbows and knees in the 63-dof body pose, and the sign that bends them.
BEND_IDXS = (52, 55, 9, 12)
BEND_SIGNS = (1.0, -1.0, -1.0, -1.0)
BENDING_FACTOR = 3.17
# VPoser v1's leaky ReLU slope and BatchNorm epsilon (human_body_prior).
VPOSER_SLOPE = 0.2
VPOSER_BN_EPS = 1e-5


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 products on or off inside the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def joint_map(use_face_contour: bool = True) -> np.ndarray:
    face = list(range(76, 76 + 51 + 17 * bool(use_face_contour)))
    return np.asarray(COCO25_BODY + LEFT_HAND + RIGHT_HAND + face)


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]; the identity
    at angle 0."""
    theta = aa.norm(dim=-1, keepdim=True)
    axis = aa / torch.where(theta > 0, theta, torch.ones_like(theta))
    kx, ky, kz = axis.unbind(-1)
    z = torch.zeros_like(kx)
    K = torch.stack([z, -kz, ky, kz, z, -kx, -ky, kx, z], -1) \
        .reshape(*aa.shape[:-1], 3, 3)
    s, c = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return eye + s * K + (1 - c) * (K @ K)


def project(points: torch.Tensor, cam_t: torch.Tensor, focal: float,
            center: torch.Tensor) -> torch.Tensor:
    """Pinhole camera with the identity rotation: [B, N, 3] -> [B, N, 2]."""
    p = points + cam_t[:, None]
    return p[..., :2] / p[..., 2:3] * focal + center


class Body:
    """SMPL-X from its .npz, in one dtype on one device."""

    def __init__(self, npz_path: str, model_cfg: dict, dtype=torch.float64,
                 device="cpu", tf32: bool = False):
        d = np.load(npz_path)
        nb, ne = model_cfg["num_betas"], model_cfg["num_expression_coeffs"]
        nh = model_cfg["num_pca_comps"]
        self.dtype, self.device, self.tf32 = dtype, torch.device(device), tf32

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=self.device)

        shapedirs = np.asarray(d["shapedirs"])
        if "exprdirs" in d.files:
            expr = np.asarray(d["exprdirs"])[..., :ne]
        else:
            expr = shapedirs[..., 300:300 + ne]
        self.v_template = t(d["v_template"])
        V = self.v_template.shape[0]
        self.dirs = t(np.concatenate([shapedirs[..., :nb], expr], -1))
        self.posedirs = t(np.asarray(d["posedirs"]).reshape(V * 3, -1).T)
        self.J_regressor = t(d["J_regressor"])
        self.weights = t(d["weights"])
        self.faces = torch.as_tensor(np.asarray(d["f"], np.int64),
                                     device=self.device)
        self.parents = [int(p) for p in np.asarray(d["kintree_table"][0],
                                                   np.int64)]
        self.parents[0] = -1
        self.hand_comps = (t(d["hands_componentsl"][:nh]),
                           t(d["hands_componentsr"][:nh]))
        self.hand_means = (t(d["hands_meanl"]), t(d["hands_meanr"]))
        self.extra_vids = torch.as_tensor(
            np.minimum(SMPLX_EXTRA_JOINT_VIDS, V - 1), device=self.device)
        self.lmk_faces = torch.as_tensor(np.asarray(d["lmk_faces_idx"], np.int64),
                                         device=self.device)
        self.lmk_bary = t(d["lmk_bary_coords"])
        self.dyn_faces = torch.as_tensor(
            np.asarray(d["dynamic_lmk_faces_idx"], np.int64), device=self.device)
        self.dyn_bary = t(d["dynamic_lmk_bary_coords"])
        self.use_face_contour = model_cfg.get("use_face_contour", True)
        self.flat_hand_mean = model_cfg.get("flat_hand_mean", False)
        self.joint_map = torch.as_tensor(joint_map(self.use_face_contour),
                                         device=self.device)

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    def full_pose(self, p: dict) -> torch.Tensor:
        hands = []
        for side, key in enumerate(("left_hand_pose", "right_hand_pose")):
            h = p[key] @ self.hand_comps[side]
            if not self.flat_hand_mean:
                h = h + self.hand_means[side]
            hands.append(h)
        return torch.cat([p["global_orient"], p["body_pose"], p["jaw_pose"],
                          p["leye_pose"], p["reye_pose"], *hands], -1)

    def forward(self, p: dict, with_vertices: bool = True) -> dict:
        """Params [B, ...] -> {vertices [B, V, 3], joints [B, K, 3] (the
        mapped keypoints), skeleton [B, 55, 3]}."""
        with matmul_precision(self.tf32):
            return self._forward({k: v.to(self.dtype) for k, v in p.items()})

    def _forward(self, p: dict) -> dict:
        B = p["global_orient"].shape[0]
        J = len(self.parents)
        coeffs = torch.cat([p["betas"], p["expression"]], -1)
        v_shaped = self.v_template + torch.einsum("bk,vck->bvc", coeffs, self.dirs)
        j_rest = torch.einsum("jv,bvc->bjc", self.J_regressor, v_shaped)
        R = rodrigues(self.full_pose(p).reshape(B, J, 3))
        eye = torch.eye(3, dtype=R.dtype, device=R.device)
        feat = (R[:, 1:] - eye).reshape(B, -1)
        v_posed = v_shaped + (feat @ self.posedirs).reshape(B, -1, 3)

        glob = [None] * J
        for j in range(J):
            local = torch.zeros(B, 4, 4, dtype=R.dtype, device=R.device)
            local[:, :3, :3] = R[:, j]
            par = self.parents[j]
            local[:, :3, 3] = j_rest[:, j] - (j_rest[:, par] if par >= 0 else 0)
            local[:, 3, 3] = 1
            glob[j] = local if par < 0 else glob[par] @ local
        G = torch.stack(glob, 1)                                # [B, J, 4, 4]
        skeleton = G[:, :, :3, 3]
        A = G.clone()
        A[:, :, :3, 3] = G[:, :, :3, 3] - torch.einsum(
            "bjmn,bjn->bjm", G[:, :, :3, :3], j_rest)
        T = torch.einsum("vj,bjk->bvk", self.weights, A.reshape(B, J, 16)) \
            .reshape(B, -1, 4, 4)
        verts = torch.einsum("bvmn,bvn->bvm", T[..., :3, :3], v_posed) \
            + T[..., :3, 3]

        lmk = torch.einsum("lc,blcx->blx", self.lmk_bary,
                           verts[:, self.faces[self.lmk_faces]])
        parts = [skeleton, verts[:, self.extra_vids], lmk]
        if self.use_face_contour:
            bucket = self._yaw_bucket(R)
            tri = self.faces[self.dyn_faces[bucket]]            # [B, 17, 3]
            lanes = torch.arange(B, device=R.device)[:, None, None]
            parts.append(torch.einsum("blc,blcx->blx", self.dyn_bary[bucket],
                                      verts[lanes, tri]))
        joints = torch.cat(parts, 1)[:, self.joint_map]
        return {"vertices": verts, "joints": joints, "skeleton": skeleton}

    def _yaw_bucket(self, R: torch.Tensor) -> torch.Tensor:
        """Contour table of each lane: the head's yaw in whole degrees
        (the public smplx package's dynamic landmark rule)."""
        Rn = torch.eye(3, dtype=R.dtype, device=R.device).expand(R.shape[0], 3, 3)
        for j in NECK_CHAIN:
            Rn = R[:, j] @ Rn
        yaw = torch.atan2(Rn[:, 2, 0],
                          torch.sqrt(Rn[:, 0, 0] ** 2 + Rn[:, 1, 0] ** 2))
        deg = torch.round(torch.clamp(yaw * 180.0 / math.pi, max=39.0)).long()
        bucket = torch.where(deg < 0, torch.where(deg < -39, 78, 39 - deg), deg)
        return torch.clamp(bucket, 0, self.dyn_faces.shape[0] - 1)


# ------------------------------------------------------------- VPoser v1


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotations [..., 6] (the first two columns of the
    matrix, row by row: x.reshape(3, 2)) -> [..., 3, 3], by Gram-Schmidt."""
    a = x.reshape(*x.shape[:-1], 3, 2)
    b1 = a[..., 0] / a[..., 0].norm(dim=-1, keepdim=True)
    a2 = a[..., 1] - (b1 * a[..., 1]).sum(-1, keepdim=True) * b1
    b2 = a2 / a2.norm(dim=-1, keepdim=True)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], -1)


def log_map(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> axis-angle [..., 3].  Below a
    quarter turn the axis is the skew part over twice the sine; above it,
    where that sine runs to 0 at a half turn, the axis is the largest
    column of (R + R^T)/2 - cos I = (1 - cos) n n^T, signed along the skew
    part.  Each branch reads a harmless stand-in where it is not taken, so
    that its gradient there is no NaN."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    trace = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = ((trace - 1) / 2).clamp(-1, 1)
    skew = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], -1)
    q = (skew * skew).sum(-1)
    sin = torch.where(q > 0, torch.sqrt(torch.where(q > 0, q, 1)) / 2, 0)
    angle = torch.atan2(sin, cos)
    ratio = torch.where(sin > 0, angle / torch.where(sin > 0, sin, 1), 1)
    near_zero = skew * (ratio / 2)[..., None]

    wide = cos <= 0
    Rw = torch.where(wide[..., None, None], R, torch.diag(
        torch.tensor([1.0, -1.0, -1.0], dtype=R.dtype, device=R.device)))
    cw = torch.where(wide, cos, -1)
    S = (Rw + Rw.transpose(-1, -2)) / 2 - cw[..., None, None] * eye
    col = S.diagonal(dim1=-2, dim2=-1).argmax(-1)
    v = torch.take_along_dim(S, col[..., None, None].expand(
        *col.shape, 3, 1), -1)[..., 0]
    n = v / v.norm(dim=-1, keepdim=True)
    sign = torch.where((n * skew).sum(-1) < 0, -1.0, 1.0).to(R.dtype)
    near_pi = n * (sign * angle)[..., None]
    return torch.where(wide[..., None], near_pi, near_zero)


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, VPOSER_SLOPE * x)


class VPoser:
    """VPoser v1 (human_body_prior) from its state_dict file, in inference
    mode, in one dtype on one device: the decoder z -> leaky(fc1) ->
    leaky(fc2) -> fc out -> 6D per joint -> rotation -> axis-angle, and the
    encoder's mean: BatchNorm on running statistics -> leaky(fc1) ->
    BatchNorm -> leaky(fc2) -> the mu head."""

    def __init__(self, path: str, dtype=torch.float64, device="cpu",
                 tf32: bool = False):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        self.dtype, self.device, self.tf32 = dtype, torch.device(device), tf32
        self.p = {k: v.to(self.device, dtype) for k, v in sd.items()
                  if not k.endswith("num_batches_tracked")}
        self.hidden, self.latent_dim = self.p["bodyprior_dec_fc1.weight"].shape
        self.num_joints = self.p["bodyprior_dec_out.weight"].shape[0] // 6

    def _fc(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return x @ self.p[name + ".weight"].T + self.p[name + ".bias"]

    def _bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        mean, var, w, b = (self.p[f"{name}.{k}"] for k in
                           ("running_mean", "running_var", "weight", "bias"))
        return (x - mean) / torch.sqrt(var + VPOSER_BN_EPS) * w + b

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents [n, L] -> body poses [n, 3 x joints] in axis-angle."""
        with matmul_precision(self.tf32):
            h = leaky_relu(self._fc("bodyprior_dec_fc1", z.to(self.dtype)))
            h = leaky_relu(self._fc("bodyprior_dec_fc2", h))
            out = self._fc("bodyprior_dec_out", h)
            R = rot6d_to_rotmat(out.reshape(-1, self.num_joints, 6))
            return log_map(R).reshape(z.shape[0], -1)

    def encode_mean(self, pose: torch.Tensor) -> torch.Tensor:
        """Body poses [n, 3 x joints] -> the posterior's mean [n, L]."""
        with matmul_precision(self.tf32):
            x = self._bn("bodyprior_enc_bn1", pose.to(self.device, self.dtype))
            h = leaky_relu(self._fc("bodyprior_enc_fc1", x))
            h = leaky_relu(self._fc("bodyprior_enc_fc2",
                                    self._bn("bodyprior_enc_bn2", h)))
            return self._fc("bodyprior_enc_mu", h)


# ------------------------------------------------------------- the energy


def layout(preset: dict) -> dict:
    """Name -> (offset, size) of the flat parameter vector of a preset:
    under VPoser the body segment is the latent."""
    body = preset["vposer_latent_dim"] if preset["use_vposer"] else 63
    hand = preset["num_pca_comps"] if preset["use_pca"] else 45
    sizes = [("cam_t", 3), ("global_orient", 3), ("body", body),
             ("betas", preset["num_betas"]),
             ("expression", preset["num_expression_coeffs"]),
             ("jaw", 3), ("leye", 3), ("reye", 3), ("lhand", hand),
             ("rhand", hand)]
    out, off = {}, 0
    for name, size in sizes:
        out[name] = (off, size)
        off += size
    return out


def unpack(preset: dict, x: torch.Tensor) -> dict:
    return {k: x[:, o:o + s] for k, (o, s) in layout(preset).items()}


def params_of(seg: dict, body_pose: torch.Tensor) -> dict:
    return dict(global_orient=seg["global_orient"], body_pose=body_pose,
                betas=seg["betas"], expression=seg["expression"],
                jaw_pose=seg["jaw"], leye_pose=seg["leye"],
                reye_pose=seg["reye"], left_hand_pose=seg["lhand"],
                right_hand_pose=seg["rhand"])


def stage_weights(preset: dict, k: int) -> dict:
    """The loss weights of stage k of a preset."""
    jaw = preset["jaw_pose_prior_weights"][k]
    if isinstance(jaw, str):
        jaw = [float(v) for v in jaw.split(",")]
    elif np.isscalar(jaw):
        jaw = [float(jaw)] * 3
    bpw = preset["body_pose_prior_weights"][k]
    return dict(body=bpw, bending=BENDING_FACTOR * bpw,
                shape=preset["shape_weights"][k],
                expr=preset["expr_weights"][k],
                hand_prior=preset["hand_pose_prior_weights"][k],
                jaw=jaw, coll=preset["coll_loss_weights"][k],
                hand_kp=preset["hand_joints_weights"][k],
                face_kp=preset["face_joints_weights"][k])


def keypoint_weights(preset: dict, conf: torch.Tensor, k: int) -> torch.Tensor:
    """[B, K] data-term weights of stage k: ones with the ignored joints
    and the body keypoints under the confidence threshold zeroed, hand and
    face slots at the stage's weights, times the confidence."""
    w = stage_weights(preset, k)
    B, K = conf.shape
    nb = 25
    base = torch.ones(B, K, dtype=conf.dtype, device=conf.device)
    ign = [j for j in preset["joints_to_ign"] if j >= 0]
    base[:, ign] = 0
    low = conf[:, :nb] < preset["confidence_threshold"]
    base[:, :nb] = torch.where(low, torch.zeros_like(base[:, :nb]), base[:, :nb])
    base[:, nb:nb + 42] = w["hand_kp"]
    base[:, nb + 42:] = w["face_kp"]
    return base * conf if preset["use_joints_conf"] else base


def cone_penalty(ta: torch.Tensor, tb: torch.Tensor, sigma: float,
                 penalize_outside: bool) -> torch.Tensor:
    """Symmetric cone-field penalty of triangle pairs [N, 3, 3] -> [N]:
    each vertex of one triangle against the other's cone (height along
    the unit normal, radius the largest corner distance from the
    centroid), both ways."""
    def one_way(src, pts):
        c = src.mean(-2)
        n = torch.linalg.cross(src[:, 1] - src[:, 0], src[:, 2] - src[:, 0],
                               dim=-1)
        n = n / torch.sqrt((n * n).sum(-1, keepdim=True) + 1e-12)
        r = torch.sqrt(((src - c[:, None]) ** 2).sum(-1).amax(-1) + 1e-12)
        rel = pts - c[:, None]
        ax = (rel * n[:, None]).sum(-1)
        radial_vec = rel - ax[..., None] * n[:, None]
        rad = torch.sqrt((radial_vec * radial_vec).sum(-1) + 1e-12)
        radial = torch.relu(1 - rad / torch.clamp(r[:, None], min=1e-9))
        phi = torch.relu(-ax / sigma) * radial
        if penalize_outside:
            phi = phi + torch.relu(1 - ax / sigma) * radial
        return (phi * phi).sum(-1)

    return one_way(ta, tb) + one_way(tb, ta)


class Collision:
    """The exact self-collision term: every pair of faces whose bounding
    boxes overlap and whose parts the filter keeps (not one part, not a
    part and its parent, not an ignored pair), scored by `cone_penalty`."""

    def __init__(self, faces: torch.Tensor, segm_path: str, preset: dict,
                 rows: int = 1024):
        with open(segm_path, "rb") as f:
            d = pickle.load(f)
        dev = faces.device
        self.faces = faces
        self.segm = torch.as_tensor(np.asarray(d["segm"], np.int64), device=dev)
        self.par = torch.as_tensor(np.asarray(d["parents"], np.int64), device=dev)
        self.ign = [tuple(int(v) for v in str(e).split(","))
                    for e in preset["ign_part_pairs"]]
        self.sigma = preset["df_cone_height"]
        self.outside = preset["penalize_outside"]
        self.rows = rows

    def pairs(self, verts: torch.Tensor) -> torch.Tensor:
        """[N, 2] face pairs (i < j) of one mesh [V, 3] that the term
        scores."""
        tri = verts[self.faces]
        lo, hi = tri.amin(1), tri.amax(1)
        F = tri.shape[0]
        cols = torch.arange(F, device=verts.device)
        out = []
        for a in range(0, F, self.rows):
            i = cols[a:a + self.rows]
            m = i[:, None] < cols[None]
            for k in range(3):
                m &= ((lo[None, :, k] <= hi[i, None, k])
                      & (hi[None, :, k] >= lo[i, None, k]))
            sa, pa = self.segm[i, None], self.par[i, None]
            sb, pb = self.segm[None], self.par[None]
            drop = (sa == sb) | (pa == sb) | (pb == sa)
            for p, q in self.ign:
                drop |= ((sa == p) & (sb == q)) | ((sa == q) & (sb == p))
            ii, jj = torch.nonzero(m & ~drop, as_tuple=True)
            out.append(torch.stack([i[ii], jj], 1))
        return torch.cat(out)

    def score(self, verts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Penalty [B] of meshes [B, V, 3], and the pairs scored [B]."""
        out, counts = [], []
        for v in verts:
            pr = self.pairs(v)
            tri = v[self.faces]
            out.append(cone_penalty(tri[pr[:, 0]], tri[pr[:, 1]], self.sigma,
                                    self.outside).sum())
            counts.append(len(pr))
        return torch.stack(out), torch.tensor(counts)

    def __call__(self, verts: torch.Tensor) -> torch.Tensor:
        return self.score(verts)[0]


def energy(body: Body, preset: dict, x: torch.Tensor, kp: torch.Tensor,
           focal: float, image_hw, collision=None, stage: int = -1,
           reg_body: torch.Tensor | None = None,
           vposer: VPoser | None = None) -> dict:
    """The SMPLify energy terms [B] of `stage` (the last by default) at
    flat parameters x [B, D] against keypoints kp [B, K, 3], with the
    body's dtype; the forward's outputs; and the exact collision pairs
    scored per frame.  Under a regression prior the pose prior is the
    distance from the regressor's pose `reg_body`.  Under VPoser the body
    segment is the latent z, which `vposer` decodes for the forward and
    the bending prior; the pose prior is |z|^2, and in the last stage
    under a regression prior |z - encode_mean(reg_body)|^2."""
    num_stages = len(preset["body_pose_prior_weights"])
    k = stage % num_stages
    w = stage_weights(preset, k)
    x = x.to(body.dtype)
    kp = kp.to(device=x.device, dtype=body.dtype)
    seg = unpack(preset, x)
    if preset["use_vposer"] and vposer is None:
        raise ValueError("a VPoser preset needs the VPoser")
    body_pose = vposer.decode(seg["body"]) if preset["use_vposer"] \
        else seg["body"]
    out = body.forward(params_of(seg, body_pose))
    H, W = image_hw
    center = torch.tensor([W / 2.0, H / 2.0], dtype=x.dtype, device=x.device)
    proj = project(out["joints"], seg["cam_t"], focal, center)
    kw = keypoint_weights(preset, kp[..., 2], k)
    r2 = ((kp[..., :2] - proj) ** 2)
    rho2 = float(preset["rho"]) ** 2
    gm = rho2 * r2 / (r2 + rho2)
    data = (kw[..., None] ** 2 * gm).sum((1, 2)) * (1000.0 / H) ** 2
    if preset["use_vposer"]:
        dev = seg["body"]
        if preset.get("regression_prior") and k == num_stages - 1:
            dev = dev - vposer.encode_mean(reg_body)
    elif preset.get("regression_prior"):
        dev = body_pose - reg_body.to(device=x.device, dtype=x.dtype)
    else:
        dev = body_pose

    def sq(a):
        return (a * a).sum(-1)

    picked = torch.stack([body_pose[:, i] * s for i, s in
                          zip(BEND_IDXS, BEND_SIGNS)], -1)
    jaw_w = torch.tensor(w["jaw"], dtype=x.dtype, device=x.device)
    terms = {
        "data": data,
        "pose_prior": sq(dev) * w["body"] ** 2,
        "shape": sq(seg["betas"]) * w["shape"] ** 2,
        "bending": (torch.exp(torch.clamp(picked, -40, 40)) ** 2).sum(-1)
        * w["bending"],
        "hands": (sq(seg["lhand"]) + sq(seg["rhand"])) * w["hand_prior"] ** 2,
        "expression": sq(seg["expression"]) * w["expr"] ** 2,
        "jaw": sq(seg["jaw"] * jaw_w),
        "collision": torch.zeros_like(data),
    }
    pairs = torch.zeros(x.shape[0], dtype=torch.int64)
    if collision is not None and w["coll"] > 0:
        pen, pairs = collision.score(out["vertices"])
        terms["collision"] = w["coll"] * pen
    return {"terms": terms, "total": sum(terms.values()), "proj": proj,
            "weights": kw, "pairs": pairs, **out}


# --------------------------------------------------------- fit quality


def procrustes_align(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Similarity-align S1 [B, N, 3] onto S2 (SVD, no reflection)."""
    mu1, mu2 = S1.mean(-2, keepdim=True), S2.mean(-2, keepdim=True)
    X1, X2 = S1 - mu1, S2 - mu2
    K = X1.transpose(-1, -2) @ X2
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).expand(K.shape).clone()
    Z[..., -1, -1] = torch.sign(torch.linalg.det(U @ Vh))
    R = V @ Z @ U.transpose(-1, -2)
    scale = (torch.diagonal(R @ K, dim1=-2, dim2=-1).sum(-1)
             / torch.clamp((X1 ** 2).sum((-2, -1)), min=1e-12))[..., None, None]
    Rt = R.transpose(-1, -2)
    return scale * (S1 @ Rt) + mu2 - scale * (mu1 @ Rt)


def pa_v2v_mm(fit: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-lane mean vertex error after Procrustes alignment, in mm."""
    aligned = procrustes_align(fit, gt)
    return 1000.0 * (aligned - gt).norm(dim=-1).mean(-1)
