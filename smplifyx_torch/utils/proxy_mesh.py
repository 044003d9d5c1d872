"""Posed-human proxy mesh with real self-contacts, for collision testing.

The port's own copy of `smplifyx_tpu/utils/proxy_mesh.py` (numpy only;
equal arrays for equal arguments).  The licensed SMPL-X artifacts don't
ship with this repo, so the collision broad phase is audited against a
stand-in with the characteristics of a posed human body mesh (the
reference's workload: 20,908 triangles, fit_single_frame.py:300-328):
~1.8 m tall, elongated along one axis, limbs whose surfaces touch or
interpenetrate other parts, and a FilterFaces-style part segmentation
{segm[F], parents[F]}.

`build_posed_human(scale_faces=1.25)` produces ~21k faces from seven
UV-ellipsoid parts: torso, head, two arms, two legs, one hand, with the
right forearm pressed INTO the torso front and the left hand touching the
left thigh (both contacts survive part filtering, exactly the pairs the
interpenetration term exists to penalize), while torso-limb root overlaps
are parent-filtered as in the real part hierarchy.
`oracle_overlap_pairs` is the exact all-pairs ground truth.
"""

from __future__ import annotations

import numpy as np


def uv_ellipsoid(center, radii, n_u=48, n_v=24, rot=None):
    """UV-sphere scaled to an ellipsoid; returns (verts [N,3], faces [F,3])."""
    u = np.linspace(0, 2 * np.pi, n_u, endpoint=False)
    v = np.linspace(0, np.pi, n_v + 1)[1:-1]  # exclude poles
    uu, vv = np.meshgrid(u, v, indexing="ij")
    x = np.sin(vv) * np.cos(uu)
    y = np.cos(vv)
    z = np.sin(vv) * np.sin(uu)
    ring = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    top = np.array([[0.0, 1.0, 0.0]])
    bot = np.array([[0.0, -1.0, 0.0]])
    verts = np.concatenate([ring, top, bot]) * np.asarray(radii)
    if rot is not None:
        verts = verts @ rot.T
    verts = verts + np.asarray(center)

    nv = n_v - 1
    idx = lambda i, j: i * nv + j
    faces = []
    for i in range(n_u):
        i2 = (i + 1) % n_u
        for j in range(nv - 1):
            a, b, c, d = idx(i, j), idx(i2, j), idx(i2, j + 1), idx(i, j + 1)
            faces.append([a, b, c])
            faces.append([a, c, d])
        faces.append([len(ring), idx(i2, 0), idx(i, 0)])
        faces.append([len(ring) + 1, idx(i, nv - 1), idx(i2, nv - 1)])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def _rot_z(t):
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def build_posed_human(scale_faces: float = 1.25):
    """-> (verts [V,3] f32, faces [F,3] i32, segm [F] i32, parents [F] i32).

    scale_faces ~ 1.25 yields ~21k faces (the SMPL-X face count);
    smaller values give proportionally coarser meshes for fast tests.
    """
    k = np.sqrt(scale_faces)
    parts = []

    def add(name, pid, parent, v, f):
        parts.append((name, pid, parent, v, f))

    # torso: part 1 (parent 0 = root)
    v, f = uv_ellipsoid([0, 0.3, 0], [0.18, 0.32, 0.11],
                        n_u=max(int(72 * k), 8), n_v=max(int(40 * k), 6))
    add("torso", 1, 0, v, f)
    # head: part 2 (parent 1)
    v, f = uv_ellipsoid([0, 0.78, 0], [0.09, 0.12, 0.1],
                        n_u=max(int(40 * k), 8), n_v=max(int(20 * k), 5))
    add("head", 2, 1, v, f)
    # left arm hanging: part 3 (parent 1)
    v, f = uv_ellipsoid([-0.28, 0.3, 0], [0.05, 0.32, 0.05],
                        n_u=max(int(40 * k), 8), n_v=max(int(26 * k), 5))
    add("l_arm", 3, 1, v, f)
    # right FOREARM folded into the torso front: part 4, parent 8 = upper
    # arm (no faces) -> torso-forearm contact SURVIVES the parent filter.
    v, f = uv_ellipsoid([0.13, 0.32, -0.10], [0.05, 0.30, 0.05],
                        n_u=max(int(40 * k), 8), n_v=max(int(26 * k), 5),
                        rot=_rot_z(0.35))
    add("r_forearm", 4, 8, v, f)
    # left hand touching the left thigh: part 5 (parent 3 = l_arm)
    v, f = uv_ellipsoid([-0.13, -0.12, 0.0], [0.045, 0.09, 0.035],
                        n_u=max(int(24 * k), 8), n_v=max(int(12 * k), 4))
    add("l_hand", 5, 3, v, f)
    # legs: parts 6, 7 (parent 1), slightly crossed so the thighs touch
    v, f = uv_ellipsoid([-0.08, -0.45, 0], [0.075, 0.45, 0.075],
                        n_u=max(int(48 * k), 8), n_v=max(int(30 * k), 6),
                        rot=_rot_z(-0.06))
    add("l_leg", 6, 1, v, f)
    v, f = uv_ellipsoid([0.08, -0.45, 0], [0.075, 0.45, 0.075],
                        n_u=max(int(48 * k), 8), n_v=max(int(30 * k), 6),
                        rot=_rot_z(0.06))
    add("r_leg", 7, 1, v, f)

    all_v, all_f, segm, parents = [], [], [], []
    off = 0
    for _, pid, parent, v, f in parts:
        all_v.append(v)
        all_f.append(f + off)
        segm.append(np.full(len(f), pid, np.int32))
        parents.append(np.full(len(f), parent, np.int32))
        off += len(v)
    return (np.concatenate(all_v), np.concatenate(all_f),
            np.concatenate(segm), np.concatenate(parents))


def oracle_overlap_pairs(verts, faces, segm, parents,
                         ign_pairs=(), chunk=2048):
    """Exact all-pairs AABB-overlap oracle with FilterFaces semantics.

    -> (idx_a, idx_b) with idx_a < idx_b, every AABB-overlapping pair that
    survives part filtering.  O(F^2) numpy, chunked; the ground truth the
    sweep broad phase is audited against.
    """
    tris = verts[faces]
    aabb_min = tris.min(axis=1)
    aabb_max = tris.max(axis=1)
    F = len(faces)
    out_i, out_j = [], []
    for s in range(0, F, chunk):
        e = min(s + chunk, F)
        ov = np.ones((e - s, F), bool)
        for k in range(3):
            ov &= aabb_min[s:e, None, k] <= aabb_max[None, :, k]
            ov &= aabb_max[s:e, None, k] >= aabb_min[None, :, k]
        sa, pa = segm[s:e, None], parents[s:e, None]
        sb, pb = segm[None, :], parents[None, :]
        ov &= ~((sa == sb) | (pa == sb) | (pb == sa))
        for p, q in ign_pairs:
            ov &= ~(((sa == p) & (sb == q)) | ((sa == q) & (sb == p)))
        ii, jj = np.nonzero(ov)
        ii = ii + s
        keep = ii < jj
        out_i.append(ii[keep])
        out_j.append(jj[keep])
    return np.concatenate(out_i), np.concatenate(out_j)
