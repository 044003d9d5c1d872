"""The benchmark's inputs, made from the seed: a synthetic SMPL-X body
model with its part segmentation, and the frames of a traffic mix
(ground-truth bodies seen by a pinhole camera, as OpenPose keypoints, with
the regressors' estimates of each body and camera).

The model's surface is closed tube grids around the SMPL-X skeleton: the
torso with the head, two legs with the feet, two arms with mitten hands
(`TUBES`), a ring of vertices every grid step and a pole at each end, cut
open at the mouth to the configuration's face count.  Each face's part is
the joint whose bone it covers, its parent part that joint's kinematic
parent, so that only a body's own contacts are scored.  The vertices that
SMPL-X's vertex joints name (nose, eyes, ears, toes, heels, finger tips)
sit where those are, and the face landmarks on the face.  Skinning weights
come from the four nearest joints, the joint regressor from the rings
around each joint, and shape, expression and pose directions are affine,
drawn from a `torch.Generator` on the given device in a few large calls,
so a later change to the program cannot move the yardstick.  The files it
is written to (`write_model`) are what a user of the program has: an
SMPL-X .npz and a part-segmentation pickle.  A configuration that sets
`use_vposer` also has a VPoser v1 checkpoint drawn from the seed
(`vposer_params`, `write_vposer`), and its traffic mix gives
`vposer_latent_std`, by which its bodies' poses are drawn as decoded
latents.
"""

from __future__ import annotations

import itertools
import os.path as osp
import pickle

import numpy as np
import torch

from perfbench import reference as ref

# Rest-pose positions of the body joints; the hand joints follow their
# parents (the program's smooth synthetic model).
BASE_JOINTS = {
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
NUM_LMK = 51
NUM_CONTOUR = 17
NUM_YAW_BUCKETS = 79


def _tube(stations, part_of, ref_axis):
    return {"stations": [(np.asarray(p, np.float64), np.asarray(r, np.float64))
                         for p, r in stations],
            "part_of": part_of, "ref": np.asarray(ref_axis, np.float64)}


def _limb(side):
    """A leg (side +1 left, -1 right): hip, knee, ankle, foot."""
    s = side
    return _tube([((0.09 * s, 0.02, 0), (0, 0)), ((0.09 * s, -0.03, 0), (.065, .065)),
                  ((0.09 * s, -0.05, 0), (.075, .075)),
                  ((0.10 * s, -0.25, 0), (.065, .065)),
                  ((0.10 * s, -0.45, 0), (.05, .05)),
                  ((0.105 * s, -0.65, 0), (.045, .045)),
                  ((0.11 * s, -0.85, 0), (.035, .035)),
                  ((0.11 * s, -0.92, 0.02), (.04, .03)),
                  ((0.11 * s, -0.92, 0.10), (.035, .025)),
                  ((0.11 * s, -0.92, 0.15), (0, 0))],
                 # station index -> the part of the bone after it
                 [1, 1, 1, 1, 4, 4, 7, 7, 10] if s > 0
                 else [2, 2, 2, 2, 5, 5, 8, 8, 11], (1, 0, 0))


def _arm(side):
    """An arm (side +1 left, -1 right): collar, shoulder, elbow, wrist and
    a mitten hand, wide across the fingers and thin through the palm."""
    s = side
    return _tube([((0.05 * s, 0.45, 0), (0, 0)), ((0.08 * s, 0.45, 0), (.04, .04)),
                  ((0.18 * s, 0.47, 0), (.05, .05)),
                  ((0.30 * s, 0.465, 0), (.045, .045)),
                  ((0.42 * s, 0.46, 0), (.04, .04)),
                  ((0.54 * s, 0.455, 0), (.035, .035)),
                  ((0.66 * s, 0.45, 0), (.03, .03)),
                  ((0.70 * s, 0.45, 0), (.042, .016)),
                  ((0.77 * s, 0.45, 0), (.042, .013)),
                  ((0.81 * s, 0.45, 0), (.035, .01)),
                  ((0.84 * s, 0.45, 0), (0, 0))],
                 [13, 13, 16, 16, 18, 18, 20, 20, 20, 20] if s > 0
                 else [14, 14, 17, 17, 19, 19, 21, 21, 21, 21], (0, 0, 1))


# Each tube: stations (centre, (radius along the reference axis, across
# it)) from pole to pole, the part of each stretch between two stations,
# and the reference axis of its rings.
TUBES = (
    _tube([((0, -0.14, 0), (0, 0)), ((0, -0.10, 0), (.10, .07)),
           ((0, 0, 0), (.13, .09)), ((0, 0.12, 0), (.13, .09)),
           ((0, 0.25, 0), (.14, .095)), ((0, 0.38, 0), (.145, .10)),
           ((0, 0.45, 0), (.08, .06)), ((0, 0.51, 0), (.045, .045)),
           ((0, 0.56, 0), (.06, .065)), ((0, 0.62, 0), (.08, .09)),
           ((0, 0.70, 0), (.07, .075)), ((0, 0.76, 0), (0, 0))],
          [0, 0, 0, 3, 6, 9, 9, 12, 12, 15, 15], (1, 0, 0)),
    _limb(1), _limb(-1), _arm(1), _arm(-1),
)
# Where SMPL-X's vertex joints sit on this surface, in the order of
# reference.SMPLX_EXTRA_JOINT_VIDS: nose, eyes, ears, toes and heels, then
# the finger tips of the left and the right mitten.
VERTEX_JOINT_SPOTS = (
    [(0, 0.61, 0.095), (-0.03, 0.63, 0.10), (0.03, 0.63, 0.10),
     (-0.09, 0.62, 0), (0.09, 0.62, 0),
     (0.12, -0.92, 0.16), (0.09, -0.92, 0.14), (0.11, -0.92, -0.04),
     (-0.12, -0.92, 0.16), (-0.09, -0.92, 0.14), (-0.11, -0.92, -0.04)]
    + [(0.83, 0.45, z) for z in (-0.03, -0.015, 0, 0.015, 0.03)]
    + [(-0.83, 0.45, z) for z in (-0.03, -0.015, 0, 0.015, 0.03)])
MOUTH = (0.0, 0.575, 0.09)      # where the surface is cut open
FACE_FRONT = (0.0, 0.60, 0.05)  # face landmarks: faces around here


# VPoser v1's body pose: 21 joints in axis-angle.
VPOSER_JOINTS = 21


def generator(seed: int, device) -> torch.Tensor:
    """A torch.Generator on `device` seeded from any whole number."""
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def rest_joints() -> np.ndarray:
    parents = ref.SMPLX_PARENTS
    J = len(parents)
    joints = np.zeros((J, 3), np.float32)
    for j, p in BASE_JOINTS.items():
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
    return joints


def _measure(tube):
    """(arc length, largest ring perimeter) of a tube."""
    p = np.stack([c for c, _ in tube["stations"]])
    r = np.stack([r for _, r in tube["stations"]])
    length = np.linalg.norm(np.diff(p, axis=0), axis=1).sum()
    a, b = r[:, 0], r[:, 1]
    per = np.pi * (3 * (a + b) - np.sqrt((3 * a + b) * (a + 3 * b)))
    return length, per.max()


def grid_plan(V: int) -> tuple[list, float]:
    """Ring size and ring count of each tube so that the vertices, a ring
    every grid step and two poles per tube, come to exactly V; and the
    grid step.  Raises where no plan fits."""
    sizes = [_measure(t) for t in TUBES]

    def plan(h):
        return [(max(6, round(per / h)), max(3, round(length / h)))
                for length, per in sizes]

    def total(p):
        return sum(n * r + 2 for n, r in p)

    lo, hi = 1e-4, 1.0
    for _ in range(60):                  # the finest step that fits in V
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if total(plan(mid)) > V else (lo, mid)
    base = plan(hi)
    for d in itertools.product(range(-1, 3), repeat=2 * len(base)):
        p = [(n + d[2 * i], r + d[2 * i + 1]) for i, (n, r) in enumerate(base)]
        if min(n for n, _ in p) >= 6 and min(r for _, r in p) >= 3 \
                and total(p) == V:
            return p, hi
    raise ValueError(f"no tube grid of exactly {V} vertices")


def _tube_mesh(tube, n, R):
    """Vertices [n R + 2], faces [2 n R] and the part of each face of one
    tube: R rings of n vertices equally spaced along its arc, a pole at
    each end."""
    p = np.stack([c for c, _ in tube["stations"]])
    rad = np.stack([r for _, r in tube["stations"]])
    seg = np.linalg.norm(np.diff(p, axis=0), axis=1)
    arc = np.concatenate([[0.0], np.cumsum(seg)])
    s = arc[-1] * (np.arange(1, R + 1) / (R + 1))
    k = np.clip(np.searchsorted(arc, s, side="right") - 1, 0, len(seg) - 1)
    f = ((s - arc[k]) / seg[k])[:, None]
    centre = p[k] + f * (p[k + 1] - p[k])
    radius = rad[k] + f * (rad[k + 1] - rad[k])
    # ring axes: the reference axis made normal to the local direction
    t = np.gradient(centre, axis=0)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    u = tube["ref"][None] - (t @ tube["ref"])[:, None] * t
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = np.cross(t, u)
    ang = 2 * np.pi * np.arange(n) / n
    ring = (centre[:, None]
            + radius[:, None, 0:1] * np.cos(ang)[None, :, None] * u[:, None]
            + radius[:, None, 1:2] * np.sin(ang)[None, :, None] * w[:, None])
    verts = np.concatenate([ring.reshape(-1, 3), p[:1], p[-1:]])
    i = np.arange(n)
    j = (i + 1) % n
    faces = []
    for r in range(R - 1):
        a, b = r * n + i, r * n + j
        c, d = (r + 1) * n + j, (r + 1) * n + i
        faces += [np.stack([a, b, c], 1), np.stack([a, c, d], 1)]
    first, last = n * R, n * R + 1
    faces.append(np.stack([np.full(n, first), j, i], 1))
    faces.append(np.stack([np.full(n, last), (R - 1) * n + i,
                           (R - 1) * n + j], 1))
    faces = np.concatenate(faces)
    # a face's part: that of the stretch its centroid lies on
    cen_s = np.concatenate([np.repeat((s[:-1] + s[1:]) / 2, 2 * n),
                            np.full(n, s[0] / 2),
                            np.full(n, (s[-1] + arc[-1]) / 2)])
    stretch = np.clip(np.searchsorted(arc, cen_s, side="right") - 1,
                      0, len(seg) - 1)
    return verts, faces, np.asarray(tube["part_of"])[stretch]


def surface(V: int, F: int) -> dict:
    """The closed tube surface of exactly V vertices and F faces (numpy):
    vertices, faces, each face's part and the grid step."""
    plan, h = grid_plan(V)
    vs, fs, parts, off = [], [], [], 0
    for tube, (n, R) in zip(TUBES, plan):
        v, f, pt = _tube_mesh(tube, n, R)
        vs.append(v)
        fs.append(f + off)
        parts.append(pt)
        off += len(v)
    verts, faces, part = np.concatenate(vs), np.concatenate(fs), \
        np.concatenate(parts)
    if F > len(faces):
        raise ValueError(f"{V} vertices close at most {len(faces)} faces")
    # open the surface at the mouth: drop the faces nearest it, each while
    # its corners keep a face
    cen = verts[faces].mean(1)
    left = np.bincount(faces.reshape(-1), minlength=V)
    drop = []
    for f in np.argsort(((cen - MOUTH) ** 2).sum(1)):
        if len(drop) == len(faces) - F:
            break
        if (left[faces[f]] > 1).all():
            left[faces[f]] -= 1
            drop.append(f)
    keep = np.setdiff1d(np.arange(len(faces)), drop)
    faces, part = faces[keep], part[keep]
    # the vertex joints' ids name the vertices nearest their spots
    perm, named = np.arange(V), []
    for vid, spot in zip(ref.SMPLX_EXTRA_JOINT_VIDS, VERTEX_JOINT_SPOTS):
        if vid >= V or vid in named:
            continue
        d = ((verts[perm] - np.asarray(spot)) ** 2).sum(1)
        d[named] = np.inf
        k = int(np.argmin(d))
        perm[[vid, k]] = perm[[k, vid]]
        named.append(int(vid))
    inv = np.empty(V, np.int64)
    inv[perm] = np.arange(V)
    return {"verts": verts[perm], "faces": inv[faces], "part": part,
            "step": h}


def body_model(model_cfg: dict, seed: int, device) -> dict:
    """The synthetic SMPL-X of `model_cfg` (num_verts, num_faces,
    num_betas, num_expression_coeffs, num_hand_components), drawn from
    `seed` on `device`: a dict of float32 / int64 tensors in the program's
    field names, with `parents`, `segm` and `segm_parents` (per face)."""
    gen = generator(seed, device)
    V, F = model_cfg["num_verts"], model_cfg["num_faces"]
    nb, ne = model_cfg["num_betas"], model_cfg["num_expression_coeffs"]
    nh = model_cfg["num_hand_components"]
    parents = torch.as_tensor(ref.SMPLX_PARENTS, dtype=torch.int64)
    J = len(parents)
    joints = torch.as_tensor(rest_joints(), device=device)
    surf = surface(V, F)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    v_template = torch.as_tensor(surf["verts"], dtype=torch.float32,
                                 device=device)
    faces = torch.as_tensor(surf["faces"], device=device)
    part = torch.as_tensor(surf["part"], device=device)

    # Skinning: the 4 nearest joints, Gaussian in the squared distance;
    # joint regressor: the rings around each joint (its 64 nearest
    # vertices, falling off over a quarter grid step past the nearest).
    d2 = ((v_template[:, None] - joints[None]) ** 2).sum(-1)      # [V, J]
    near_d2, near = torch.topk(d2, 4, dim=1, largest=False)
    w = torch.exp(-near_d2 / 0.02)
    w = w / (w.sum(1, keepdim=True) + 1e-12)
    lbs = torch.zeros(V, J, device=device).scatter_(1, near, w)
    jd2, jnear = torch.topk(d2.T, min(64, V), dim=1, largest=False)
    jd = jd2.clamp_min(0).sqrt()
    jw = torch.exp(-(jd - jd[:, :1]) / (0.25 * surf["step"]))
    jw = jw / jw.sum(1, keepdim=True)
    J_regressor = torch.zeros(J, V, device=device).scatter_(1, jnear, jw)

    def affine_dirs(k, scale):
        A = normal(k, 3, 3, scale=scale)
        bvec = normal(k, 3, scale=scale * 0.5)
        return torch.einsum("kcd,vd->vck", A, v_template) + bvec.T[None]

    shapedirs = affine_dirs(nb, 0.03)
    exprdirs = affine_dirs(ne, 0.005)
    posedirs = affine_dirs((J - 1) * 9, 1.5e-4).reshape(V * 3, -1).T
    segm_parents = torch.clamp(parents.to(device)[part], min=0)

    # Face landmarks: faces around the front of the face.
    cen = v_template[faces].mean(1)
    front = torch.topk(((cen - torch.tensor(FACE_FRONT, device=device)) ** 2)
                       .sum(1), min(4 * NUM_LMK, F), largest=False).indices

    def on_face(n):
        return front[torch.randint(0, len(front), (n,), generator=gen,
                                   device=device)]

    return dict(
        v_template=v_template, shapedirs=shapedirs, exprdirs=exprdirs,
        posedirs=posedirs, J_regressor=J_regressor, lbs_weights=lbs,
        faces=faces, parents=parents,
        left_hand_components=normal(nh, 45, scale=0.4),
        right_hand_components=normal(nh, 45, scale=0.4),
        left_hand_mean=torch.zeros(45, device=device),
        right_hand_mean=torch.zeros(45, device=device),
        lmk_faces_idx=on_face(NUM_LMK),
        lmk_bary_coords=_dirichlet(gen, NUM_LMK, device),
        dyn_lmk_faces_idx=on_face(NUM_CONTOUR)[None]
        .expand(NUM_YAW_BUCKETS, NUM_CONTOUR),
        dyn_lmk_bary_coords=_dirichlet(gen, NUM_CONTOUR, device)[None]
        .expand(NUM_YAW_BUCKETS, NUM_CONTOUR, 3),
        segm=part, segm_parents=segm_parents,
    )


def _dirichlet(gen, n, device):
    """n barycentric triples, Dirichlet(1, 1, 1)."""
    e = -torch.log(torch.rand(n, 3, generator=gen, device=device)
                   .clamp_min(1e-12))
    return e / e.sum(1, keepdim=True)


def write_model(model: dict, folder: str) -> dict:
    """Write the model as a user's files under `folder`: the SMPL-X .npz
    (`posedirs` [V, 3, P], `kintree_table`, `weights`, `f`, hand PCA,
    landmark tables; shape and expression directions under `shapedirs`
    and `exprdirs`) and the part segmentation {segm, parents}.  Returns
    their paths."""
    def np_(t):
        return t.detach().cpu().numpy()

    V = model["v_template"].shape[0]
    parents = np_(model["parents"])
    paths = {"model": osp.join(folder, "SMPLX_NEUTRAL.npz"),
             "part_segm": osp.join(folder, "parts_segm.pkl")}
    np.savez(
        paths["model"], v_template=np_(model["v_template"]),
        shapedirs=np_(model["shapedirs"]), exprdirs=np_(model["exprdirs"]),
        posedirs=np_(model["posedirs"]).T.reshape(V, 3, -1),
        J_regressor=np_(model["J_regressor"]),
        weights=np_(model["lbs_weights"]),
        f=np_(model["faces"]).astype(np.uint32),
        kintree_table=np.stack([np.where(parents < 0, 2**32 - 1, parents),
                                np.arange(len(parents))]).astype(np.uint32),
        hands_componentsl=np_(model["left_hand_components"]),
        hands_componentsr=np_(model["right_hand_components"]),
        hands_meanl=np_(model["left_hand_mean"]),
        hands_meanr=np_(model["right_hand_mean"]),
        lmk_faces_idx=np_(model["lmk_faces_idx"]),
        lmk_bary_coords=np_(model["lmk_bary_coords"]),
        dynamic_lmk_faces_idx=np_(model["dyn_lmk_faces_idx"]),
        dynamic_lmk_bary_coords=np_(model["dyn_lmk_bary_coords"]),
    )
    with open(paths["part_segm"], "wb") as f:
        pickle.dump({"segm": np_(model["segm"]).astype(np.int32),
                     "parents": np_(model["segm_parents"]).astype(np.int32)}, f)
    return paths


def vposer_params(vposer_cfg: dict, latent_dim: int, seed: int,
                  device) -> dict:
    """A VPoser v1 state_dict (human_body_prior's names, float32 on
    `device`) drawn from `seed` on a stream of its own, with the preset's
    `vposer_latent_dim` and the configuration's `vposer` section (`hidden`,
    the published width, and `mean_pose` as [index, value] pairs).  Every
    Linear is uniform in +-1/sqrt(fan_in), torch's default bounds.  The
    BatchNorms' running statistics lie away from the identity: the
    first's mean is `mean_pose` moved by 0.05 rad, its variance 0.01-0.03
    rad^2 (the poses' spread), the second's mean and variance about the
    first hidden layer's; their affine weights 0.8-1.2, biases 0.1 about
    0.  The output layer's bias is the 6D form of `mean_pose` less what
    the layer adds at z = 0, so that the decoder gives `mean_pose` at
    z = 0, as a trained one gives a mean pose near it."""
    gen = generator(seed + 5, device)
    L, H = latent_dim, vposer_cfg["hidden"]
    P = 3 * VPOSER_JOINTS
    linears = {"bodyprior_enc_fc1": (P, H), "bodyprior_enc_fc2": (H, H),
               "bodyprior_enc_mu": (H, L), "bodyprior_enc_logvar": (H, L),
               "bodyprior_dec_fc1": (L, H), "bodyprior_dec_fc2": (H, H),
               "bodyprior_dec_out": (H, 6 * VPOSER_JOINTS)}

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device)

    sd = {}
    for name, (n_in, n_out) in linears.items():
        b = 1.0 / n_in ** 0.5
        sd[name + ".weight"] = uniform((n_out, n_in), -b, b)
        sd[name + ".bias"] = uniform((n_out,), -b, b)
    mean = torch.zeros(P, device=device)
    for i, v in vposer_cfg["mean_pose"]:
        mean[i] += v
    stats = {"bodyprior_enc_bn1": (mean, 0.05, (0.01, 0.03)),
             "bodyprior_enc_bn2": (torch.zeros(H, device=device), 0.1,
                                   (0.05, 0.2))}
    for name, (mu, spread, var) in stats.items():
        n = mu.numel()
        sd[name + ".running_mean"] = mu + spread * torch.randn(
            n, generator=gen, device=device)
        sd[name + ".running_var"] = uniform((n,), *var)
        sd[name + ".weight"] = uniform((n,), 0.8, 1.2)
        sd[name + ".bias"] = 0.1 * torch.randn(n, generator=gen, device=device)

    def fc(name, x):
        return x @ sd[name + ".weight"].double().T + sd[name + ".bias"].double()

    h0 = ref.leaky_relu(fc("bodyprior_dec_fc2", ref.leaky_relu(
        sd["bodyprior_dec_fc1.bias"].double()[None])))
    R = ref.rodrigues(mean.double().reshape(VPOSER_JOINTS, 3))
    six = R[..., :2].reshape(-1)
    sd["bodyprior_dec_out.bias"] = (six - h0[0] @ sd[
        "bodyprior_dec_out.weight"].double().T).float()
    return sd


def write_vposer(params: dict, folder: str) -> str:
    """Write a VPoser state_dict as a user's checkpoint; returns its path."""
    path = osp.join(folder, "vposer_v1.pt")
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)
    return path


def ground_truth(traffic: dict, num_frames: int, focal: float, seed: int,
                 device, nh: int, nb: int, ne: int,
                 vposer: "ref.VPoser | None" = None) -> dict:
    """Ground-truth bodies and cameras of `num_frames` frames, float64 on
    `device`: every parameter of the flat layout, each axis-angle body
    component `pose_std` about the traffic's `body_pose_mean` ([index,
    value] pairs: the arms lowered to the sides), and the camera
    translation (depth scaled with the focal length, so a body covers the
    same share of the image at any focal).  Given a `vposer`, the body
    poses are instead the decodes of latents z ~ N(0, the traffic's
    `vposer_latent_std`, which it must give) (`truth_latents`), so that
    each lies in the decoder's image; every other draw stays."""
    gen = generator(seed + 2, device)

    def normal(n, scale):
        return torch.randn(num_frames, n, generator=gen, device=device,
                           dtype=torch.float64) * scale

    lo, hi = traffic["depth_m_at_focal_1000"]
    depth = lo + (hi - lo) * torch.rand(num_frames, 1, generator=gen,
                                        device=device, dtype=torch.float64)
    body_pose = normal(63, traffic["pose_std"])
    for i, v in traffic.get("body_pose_mean", []):
        body_pose[:, i] += v
    if vposer is not None:
        body_pose = vposer.decode(truth_latents(traffic, num_frames,
                                                vposer.latent_dim, seed,
                                                device))
    return dict(
        global_orient=normal(3, traffic["orient_std"]),
        body_pose=body_pose,
        betas=normal(nb, traffic["betas_std"]),
        expression=normal(ne, traffic["expression_std"]),
        jaw_pose=normal(3, traffic["jaw_std"]),
        leye_pose=torch.zeros(num_frames, 3, device=device, dtype=torch.float64),
        reye_pose=torch.zeros(num_frames, 3, device=device, dtype=torch.float64),
        left_hand_pose=normal(nh, traffic["hand_pca_std"]),
        right_hand_pose=normal(nh, traffic["hand_pca_std"]),
        cam_t=torch.cat([normal(2, traffic["cam_xy_std"]),
                         depth * focal / 1000.0], dim=1),
    )


def truth_latents(traffic: dict, num_frames: int, latent_dim: int, seed: int,
                  device) -> torch.Tensor:
    """The latents [num_frames, latent_dim] whose decodes are the truth's
    body poses under VPoser: N(0, `vposer_latent_std`), float64, on a
    stream of their own."""
    gen = generator(seed + 6, device)
    return torch.randn(num_frames, latent_dim, generator=gen, device=device,
                       dtype=torch.float64) * traffic["vposer_latent_std"]


def regression(gt: dict, traffic: dict, seed: int, device) -> dict:
    """The body regressors' estimates of each frame (the preset's
    regression prior and camera prior), float64 on `device`: the ground
    truth's body pose and global orientation, each component moved by
    Gaussian noise of `regression_pose_std`, and its camera translation,
    sideways by `regression_cam_xy_std` metres and in depth by a share of
    `regression_depth_rel_std`."""
    gen = generator(seed + 4, device)

    def noise(like, scale):
        return torch.randn(like.shape, generator=gen, device=device,
                           dtype=torch.float64) * scale

    t = gt["cam_t"]
    s = traffic["regression_pose_std"]
    return dict(
        body_pose=gt["body_pose"] + noise(gt["body_pose"], s),
        global_orient=gt["global_orient"] + noise(gt["global_orient"], s),
        cam_t=torch.cat([t[:, :2] + noise(t[:, :2],
                                          traffic["regression_cam_xy_std"]),
                         t[:, 2:] * (1 + noise(t[:, 2:], traffic[
                             "regression_depth_rel_std"]))], 1),
    )


def keypoints(body: "ref.Body", gt: dict, traffic: dict, focal: float,
              image_hw, seed: int, device, chunk: int = 256) -> np.ndarray:
    """[N, K, 3] OpenPose keypoints (x, y, conf) of the ground truth: the
    mapped joints projected by the frame's camera, moved by Gaussian pixel
    noise, with confidences uniform in the traffic's range."""
    gen = generator(seed + 3, device)
    N = gt["cam_t"].shape[0]
    H, W = image_hw
    center = torch.tensor([W / 2.0, H / 2.0], dtype=torch.float64,
                          device=device)
    out = []
    for lo in range(0, N, chunk):
        part = {k: v[lo:lo + chunk] for k, v in gt.items()}
        joints = body.forward(part, with_vertices=False)["joints"]
        out.append(ref.project(joints, part["cam_t"], focal, center))
    uv = torch.cat(out)
    K = uv.shape[1]
    uv = uv + torch.randn(N, K, 2, generator=gen, device=device,
                          dtype=torch.float64) * traffic["noise_px"]
    c_lo, c_hi = traffic["confidence"]
    conf = c_lo + (c_hi - c_lo) * torch.rand(N, K, 1, generator=gen,
                                             device=device, dtype=torch.float64)
    return torch.cat([uv, conf], -1).float().cpu().numpy()
