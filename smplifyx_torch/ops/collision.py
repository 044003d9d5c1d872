"""Self-intersection penalty: Morton-block AABB hierarchy + cone field.

Counterpart of `smplifyx_tpu/ops/collision.py`, batched over lanes: every
function takes vertices [B, V, 3] and every table carries a leading lane
dimension, where the JAX package runs one lane under `vmap`.

  1. triangles sort by the Morton code of their AABB centroid, giving
     spatially tight 8-triangle blocks and 64-triangle superblocks;
  2. candidate pairs flow through a three-level funnel (superblock
     all-pairs -> block refinement -> triangle refinement with the
     FilterFaces part test), each level compacted to a fixed budget;
  3. the surviving pairs are deduplicated to at most T unique triangles,
     and a differentiable cone penetration field scores each pair,
     vertex against triangle in both directions.

The broad phase carries no gradient.  Its level-2 hit detection runs on
the card as kernel K4 (`level2_hits`, csrc/collision.cu: one warp per
slot, no bool masks in device memory); `level2_hits_reference` is the
same function in plain torch, which a CPU tensor takes.  The narrow phase
fetches the pair corners in two levels (vertices -> unique-triangle
corner rows -> pair sides) with kernel K2 and takes its gradient with
kernel K3 (ops/gather.py); `pair_gather_reference` is the same function
in plain torch indexing.  The ids of both levels are fixed until the next broad
phase, so the aux carries their row plans (the sort K3 reads), built once
per broad phase.  While the span recorder records (`utils/timing.py`),
each broad phase is a `broad_phase` span with the slots the narrow phase
scores and the live pairs among them, and level 2's slots and the ones K4
skips, having no block pair (device scalars).

Every step is comparisons, compactions and IEEE arithmetic, so on the same
vertices the pair lists equal the JAX package's.  The TPU-only one-hot
routings of the JAX module (`_split3f`, `_oh_gather_small`,
`_gather_rows_mm`, `_scatter_add_mm`) are not carried over: the port
indexes, as the JAX package does on the CPU.
"""

from __future__ import annotations

import copy
import ctypes
import pickle
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from smplifyx_torch.ops import nvcc
from smplifyx_torch.ops.gather import (
    _device_of,
    _launch,
    gather_reference,
    gather_rows,
    row_plan,
    scatter_add_rows,
)
from smplifyx_torch.utils import timing
from smplifyx_torch.utils.graphs import segment

_BLK = 8  # triangles per block (broad-phase leaf)
_SUP = 8  # blocks per superblock
_BIG = 1e30
_MAX_IGN = 16  # K4's ignored part pairs (csrc/collision.cu MAX_IGN)


def load_part_segm(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load a parts-segmentation pickle {segm: [F], parents: [F]} (the
    schema of smplx_parts_segm.pkl)."""
    with open(path, "rb") as f:
        d = pickle.load(f, encoding="latin1")
    return np.asarray(d["segm"], np.int32), np.asarray(d["parents"], np.int32)


def synthetic_part_segm(num_faces: int, num_parts: int = 27, seed: int = 0):
    """Random part segmentation with the same structure, for tests and the
    synthetic slice (equal to the JAX package's for one seed)."""
    rng = np.random.default_rng(seed)
    segm = rng.integers(0, num_parts, size=num_faces).astype(np.int32)
    part_parent = rng.integers(0, num_parts, size=num_parts).astype(np.int32)
    return segm, part_parent[segm]


class CollisionAux(NamedTuple):
    """A broad-phase result reused across evaluations; every field [B, ...]
    and lane-local, so auxes merge lane by lane.  Built by `make_aux`.  The
    narrow phase's ids live only in the row plans (ops/gather.py
    `row_plan`, int32); `tri_corners`, `pa` and `pb` read them there."""

    corner_plan: torch.Tensor   # [B, 3, 3T] row plan of the corner vertex ids
    pair_plan: torch.Tensor     # [B, 3, 2P] row plan of the pair sides (A, B)
    valid: torch.Tensor         # [B, P] bool
    order: torch.Tensor         # [B, F] Morton permutation of the faces
    sorted_pack: torch.Tensor   # [B, F, 3] faces in Morton order

    @property
    def tri_corners(self) -> torch.Tensor:
        """[B, T, 3] corner vertex ids of the unique triangles."""
        return self.corner_plan[:, 0].reshape(self.corner_plan.shape[0], -1, 3)

    @property
    def pa(self) -> torch.Tensor:
        """[B, P] pair side A: index into tri_corners."""
        return self.pair_plan[:, 0, :self.valid.shape[1]]

    @property
    def pb(self) -> torch.Tensor:
        """[B, P] pair side B."""
        return self.pair_plan[:, 0, self.valid.shape[1]:]


def row_plans(tri_corners, pa, pb):
    """The row plans (ops/gather.py `row_plan`) of the narrow phase's two
    gather levels: the corner ids and the pair sides."""
    B, T, _ = tri_corners.shape
    return (row_plan(tri_corners.reshape(B, 3 * T)),
            row_plan(torch.cat([pa, pb], dim=1)))


def make_aux(tri_corners, pa, pb, valid, order, sorted_pack) -> CollisionAux:
    """The aux of a broad phase: the row plans of its gather levels in
    place of the ids."""
    return CollisionAux(*row_plans(tri_corners, pa, pb), valid, order,
                        sorted_pack)


def _cone_penalty_pairs(ta, tb, sigma: float, penalize_outside: bool,
                        point2plane: bool = False) -> torch.Tensor:
    """Symmetric cone-field penalty per pair: ta, tb [B, P, 3, 3] -> [B, P].

    point2plane takes the raw plane distance of the penetrating vertex,
    hard-gated to the triangle's circumcircle (gate without gradient),
    instead of the smooth conical falloff."""

    def one_way(src, pts):
        c = src.mean(dim=-2)                                  # [B, P, 3]
        n = torch.linalg.cross(src[..., 1, :] - src[..., 0, :],
                               src[..., 2, :] - src[..., 0, :], dim=-1)
        n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
        # circumradius proxy: max corner distance from the centroid
        d2 = torch.sum((src - c[..., None, :]) ** 2, dim=-1)  # [B, P, 3]
        r = torch.sqrt(torch.amax(d2, dim=-1) + 1e-12)        # [B, P]
        rel = pts - c[..., None, :]
        ax = torch.sum(rel * n[..., None, :], dim=-1)         # [B, P, 3]
        rad_vec = rel - ax[..., None] * n[..., None, :]
        # eps-safe norm: sqrt has a NaN gradient at exactly 0
        rad = torch.sqrt(torch.sum(rad_vec * rad_vec, dim=-1) + 1e-12)
        r_safe = torch.clamp(r[..., None], min=1e-9)
        if point2plane:
            inside = (rad <= r_safe).to(ax.dtype).detach()
            phi = torch.relu(-ax / sigma) * inside
            if penalize_outside:
                phi = phi + torch.relu(1.0 - ax / sigma) * inside
        else:
            radial = torch.relu(1.0 - rad / r_safe)
            phi = torch.relu(-ax / sigma) * radial
            if penalize_outside:
                phi = phi + torch.relu(1.0 - ax / sigma) * radial
        return torch.sum(phi * phi, dim=-1)

    return one_way(ta, tb) + one_way(tb, ta)


def _interleave3(x: torch.Tensor) -> torch.Tensor:
    """Spread each of the low 10 bits of x to every 3rd bit (Morton).
    int64 with the JAX package's uint32 masks: for x < 1024 no bit leaves
    the low 32, so the codes are equal."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact(flat: torch.Tensor, size: int):
    """Per lane, the indices of the first `size` True entries of flat
    [B, N] in order, and a validity mask.  Keys are distinct (True entries
    by N - idx, False by -idx), so the top-k order is unique."""
    N = flat.shape[-1]
    idx = torch.arange(N, device=flat.device)
    key = torch.where(flat, N - idx, -idx)
    vals, pos = torch.topk(key, size, dim=-1, sorted=True)
    valid = vals > 0
    return torch.where(valid, pos, 0), valid


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Per-lane row fetch: table [B, N, ...], ids [B, R] -> [B, R, ...]."""
    lanes = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[lanes, ids]


def _ea(v):
    """A-side expansion [..., 8] -> [..., 64]: col i*8+j -> v[..., i]."""
    return torch.repeat_interleave(v, _SUP, dim=-1)


def _eb(v):
    """B-side expansion [..., 8] -> [..., 64]: col i*8+j -> v[..., j]."""
    return v.repeat((1,) * (v.dim() - 1) + (_SUP,))


def _pair_cols(device):
    """(i, j) of each column i*8+j of an 8x8 pair row, [64] each."""
    cols = torch.arange(64, device=device)
    return cols // 8, cols % 8


def _overlap(m, A_, B_):
    """m & the AABB overlap of every column i*8+j of an 8x8 pair row: the
    packed rows A_, B_ [..., C*8] hold the 8 boxes' min x, y, z then max
    x, y, z, 8 values per coordinate."""
    for k in range(3):
        m = m & (_eb(B_[..., k * 8:(k + 1) * 8])
                 <= _ea(A_[..., (3 + k) * 8:(4 + k) * 8])) \
            & (_eb(B_[..., (3 + k) * 8:(4 + k) * 8])
               >= _ea(A_[..., k * 8:(k + 1) * 8]))
    return m


def _rel_drop(ign, sa, pa, sb, pb):
    """The FilterFaces part test: a pair drops when its parts are equal or
    one is the other's parent, or (sa, sb) is an ignored pair."""
    drop = (sa == sb) | (pa == sb) | (pb == sa)
    for p_, q_ in ign:
        drop = drop | ((sa == p_) & (sb == q_)) | ((sa == q_) & (sb == p_))
    return drop


def level2_hits_reference(blk_tab8, si_h, sj_h, mb_h, ign):
    """Plain version of K4: [B, Phs, 8j, 8ti, 8tj] slabs, one per A-side
    block i, reduced to the block pairs that carry a surviving triangle
    pair (`level2_hits`)."""
    B, Phs = si_h.shape
    Cb = blk_tab8.shape[-1] // (_SUP * _BLK)
    dev = blk_tab8.device
    A8 = _rows(blk_tab8, si_h).reshape(B, Phs, _SUP, Cb, _BLK)
    B8 = _rows(blk_tab8, sj_h).reshape(B, Phs, _SUP, Cb, _BLK)
    ti_r = torch.arange(_BLK, device=dev)
    j_r = torch.arange(_SUP, device=dev)
    rb = (((sj_h[..., None] * _SUP + j_r) * _BLK)[..., None, None]
          + ti_r[None, None, :])                        # [B, Phs, 8j, 1, 8tj]
    Bk = [B8[:, :, :, k, None, :] for k in range(Cb)]   # [B, Phs, 8j, 1, 8tj]
    hit_cols = []
    for i in range(_SUP):
        Ai = A8[:, :, i]                                # [B, Phs, Cb, 8ti]
        m = mb_h[:, :, i * _SUP:(i + 1) * _SUP, None, None]
        ra = (((si_h * _SUP + i) * _BLK)[..., None, None, None]
              + ti_r[:, None])                          # [B, Phs, 1, 8ti, 1]
        m = m & (ra < rb)
        for k in range(3):
            m = m & (Bk[k] <= Ai[:, :, None, 3 + k, :, None]) \
                & (Bk[3 + k] >= Ai[:, :, None, k, :, None])
        if Cb == 8:
            m = m & ~_rel_drop(
                ign, Ai[:, :, None, Cb - 2, :, None],
                Ai[:, :, None, Cb - 1, :, None], Bk[Cb - 2], Bk[Cb - 1])
        hit_cols.append(m.any(dim=(3, 4)))             # [B, Phs, 8j]
    return torch.cat(hit_cols, dim=-1)


def _load_k4():
    p, i = ctypes.c_void_p, ctypes.c_int
    return nvcc.load("collision", {
        "level2_hits_forward": [p] * 5 + [i] * 5 + [p, p]})


def level2_hits(blk_tab8, si_h, sj_h, mb_h, ign=()):
    """Level 2 of the broad phase: which block pairs of level 1's
    survivors carry at least one triangle pair in rank order, with
    overlapping AABBs and (with parts) passing the part test.

    blk_tab8 [B, ns, 8 * Cb * 8] f32, the packed block rows of each
    superblock (Cb = 8 with parts, 6 without), si_h, sj_h [B, Phs] int64
    superblock pairs, mb_h [B, Phs, 64] bool their block pairs, `ign` the
    ignored part pairs [(p, q), ...] -> hit_bp [B, Phs, 64] bool, a subset
    of mb_h.  Comparisons only: the card's bits equal the plain version's.
    On a CUDA tensor one launch of K4 (csrc/collision.cu; at most 16
    ignored pairs), on a CPU tensor `level2_hits_reference`.
    `level2_hits.launches` counts K4's launches."""
    name = "level2_hits"
    if blk_tab8.dtype != torch.float32 or blk_tab8.dim() != 3:
        raise TypeError(f"{name}: the table must be [B, ns, 8 * Cb * 8] "
                        f"float32, got {blk_tab8.dtype} {tuple(blk_tab8.shape)}")
    B, ns, width = blk_tab8.shape
    if width not in (8 * 8 * _BLK, 8 * 6 * _BLK):
        raise ValueError(f"{name}: table rows of {width} floats; expected "
                         f"{8 * 8 * _BLK} (with parts) or {8 * 6 * _BLK}")
    for t, what in ((si_h, "si_h"), (sj_h, "sj_h")):
        if t.dtype != torch.int64 or t.dim() != 2 or t.shape[0] != B:
            raise ValueError(f"{name}: {what} must be [B={B}, Phs] int64, got "
                             f"{t.dtype} {tuple(t.shape)}")
    Phs = si_h.shape[1]
    if tuple(sj_h.shape) != (B, Phs) or mb_h.dtype != torch.bool \
            or tuple(mb_h.shape) != (B, Phs, 64):
        raise ValueError(f"{name}: sj_h [B, Phs] and mb_h [B, Phs, 64] bool "
                         f"must match si_h {tuple(si_h.shape)}, got "
                         f"{tuple(sj_h.shape)} and {mb_h.dtype} "
                         f"{tuple(mb_h.shape)}")
    dev = _device_of(name, blk_tab8, si_h, sj_h, mb_h)
    if dev.type == "cpu":
        return level2_hits_reference(blk_tab8, si_h, sj_h, mb_h, ign)
    if not all(t.is_contiguous() for t in (blk_tab8, si_h, sj_h, mb_h)) \
            or blk_tab8.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes contiguous tensors and a "
                         "16-byte aligned table")
    with_parts = width == 8 * 8 * _BLK
    if with_parts and len(ign) > _MAX_IGN:
        raise ValueError(f"{name}: the kernel takes at most {_MAX_IGN} "
                         f"ignored part pairs, got {len(ign)}")
    pq = np.asarray(ign, np.float32).reshape(-1)
    out = torch.empty(B, Phs, 64, dtype=torch.bool, device=dev)
    _launch(name, _load_k4().level2_hits_forward,
            blk_tab8.data_ptr(), si_h.data_ptr(), sj_h.data_ptr(),
            mb_h.data_ptr(), out.data_ptr(), B, ns, Phs, int(with_parts),
            len(ign) if with_parts else 0,
            pq.ctypes.data_as(ctypes.c_void_p), dev=dev)
    level2_hits.launches += 1
    return out


level2_hits.launches = 0


class _PairGather(torch.autograd.Function):
    """Two-level narrow-phase corner fetch, forward on K2 and VJP on K3.

    vertices [B, V, 3], corner_plan [B, 3, 3T] and pair_plan [B, 3, 2P]
    (the row plans of tri_corners and of cat(pa, pb)) -> (ta, tb)
    [B, P, 3, 3].  Forward: level 1 gathers the 3T corner positions from
    the vertex table (C = 3), level 2 the pair sides from the [T, 9] corner
    rows (C = 9).  Backward: the same levels transposed, level 2 first, on
    the same plans.  No gradient flows to the ids."""

    @staticmethod
    def forward(ctx, vertices, corner_plan, pair_plan):
        B, T, P = vertices.shape[0], corner_plan.shape[2] // 3, pair_plan.shape[2] // 2
        c9 = gather_rows(vertices, corner_plan[:, 0]).reshape(B, T, 9)
        rows = gather_rows(c9, pair_plan[:, 0]).reshape(B, 2, P, 3, 3)
        ctx.save_for_backward(corner_plan, pair_plan)
        ctx.num_verts = vertices.shape[1]
        return rows[:, 0], rows[:, 1]

    @staticmethod
    def backward(ctx, gta, gtb):
        corner_plan, pair_plan = ctx.saved_tensors
        B, T = corner_plan.shape[0], corner_plan.shape[2] // 3
        gp = torch.cat([gta.reshape(B, -1, 9), gtb.reshape(B, -1, 9)], dim=1)
        gc9 = scatter_add_rows(pair_plan, gp.contiguous(), T)
        dv = scatter_add_rows(corner_plan, gc9.reshape(B, -1, 3), ctx.num_verts)
        return dv, None, None


def pair_gather(vertices, tri_corners, pa, pb):
    """(ta, tb) [B, P, 3, 3]: the pair sides' corner positions through K2,
    differentiable in vertices through K3, on row plans built here (the
    collision term passes its aux's to `_PairGather`)."""
    return _PairGather.apply(vertices, *row_plans(tri_corners, pa, pb))


def pair_gather_reference(vertices, tri_corners, pa, pb):
    """Plain version of `pair_gather`: the same two levels by indexing
    (autograd's own index backward gives the VJP)."""
    B, T, _ = tri_corners.shape
    P = pa.shape[1]
    c9 = gather_reference(vertices, tri_corners.reshape(B, 3 * T)).reshape(B, T, 9)
    rows = gather_reference(c9, torch.cat([pa, pb], dim=1)).reshape(B, 2, P, 3, 3)
    return rows[:, 0], rows[:, 1]


class CollisionFn:
    """vertices [B, V, 3] -> penetration penalty [B].

    `build(vertices)` runs the broad phase into a `CollisionAux`;
    `build_refresh(vertices, aux)` re-runs the funnel under the aux's
    Morton order; `apply(vertices, aux)` scores a fixed pair list, with an
    AABB recheck at the current vertices so separated pairs score zero;
    calling the object is `apply(vertices, build(vertices))`, the exact
    per-evaluation path.  `candidate_pairs` returns face-id pairs and
    `saturation` the survivors against the budget at every level.
    Built by `make_collision_fn`."""

    def __init__(self, faces, segm, parents, ign_part_pairs, max_pairs,
                 max_sup_pairs, max_hit_sup_pairs, max_hit_pairs, max_tris,
                 sigma, penalize_outside, point2plane):
        self.ign = [tuple(int(v) for v in str(e).split(","))
                    for e in ign_part_pairs]
        if segm is not None and len(self.ign) > _MAX_IGN:
            # K4 packs the pairs into a 32-bit mask per triangle; the CPU
            # refuses the same list, so both devices fit the same terms
            raise ValueError(f"ign_part_pairs: the collision term takes at "
                             f"most {_MAX_IGN} ignored part pairs, got "
                             f"{len(self.ign)}")
        self.faces = torch.as_tensor(faces).to(torch.int64)
        self.device = self.faces.device
        F = self.faces.shape[0]
        self.F = F
        self.nb = -(-F // _BLK)
        self.Fp = self.nb * _BLK
        self.ns = -(-self.nb // _SUP)
        self.nbp = self.ns * _SUP
        self.Ps = min(max_sup_pairs, self.ns * self.ns)
        self.Phs = min(max_hit_sup_pairs, self.Ps)
        self.Ph = min(max_hit_pairs, self.Phs * _SUP * _SUP)
        self.P = min(max_pairs, self.Ph * _BLK * _BLK)
        self.T = min(max_tris, 2 * self.P)
        self.sigma = sigma
        self.penalize_outside = penalize_outside
        self.point2plane = point2plane
        pad = self.Fp - F
        if segm is not None:
            # pad ids: distinct negatives so padding never matches anything
            # (f32 as in the JAX package; part ids are small, f32-exact)
            self.segm = torch.as_tensor(np.concatenate(
                [np.asarray(segm, np.float32), np.full(pad, -1, np.float32)]),
                device=self.device)
            self.parents = torch.as_tensor(np.concatenate(
                [np.asarray(parents, np.float32), np.full(pad, -3, np.float32)]),
                device=self.device)
        else:
            self.segm = self.parents = None

    def to(self, device) -> "CollisionFn":
        """A copy of the term with its tables on `device` (how a worker of
        parallel/mesh.py::fit_batch_sharded takes it to its card)."""
        out = copy.copy(self)
        out.faces = self.faces.to(device)
        out.device = out.faces.device
        if self.segm is not None:
            out.segm, out.parents = self.segm.to(device), self.parents.to(device)
        return out

    # ---- broad phase ---------------------------------------------------
    #
    # A chain of named steps over a state dict: `_step_<name>(st)` returns
    # the entries it adds.  `build`, `build_refresh`, `saturation` and
    # `candidate_pairs` run a prefix or all of it;
    # tools/profile_collision.py times each step on its own inputs.

    BUILD_STEPS = ("aabb", "morton_sort", "sorted_tables", "level0",
                   "level1", "level2", "final", "narrow_tris", "row_plans")
    # build_refresh keeps the previous aux's Morton order: no sort.
    REFRESH_STEPS = tuple(s for s in BUILD_STEPS if s != "morton_sort")

    def run_steps(self, st: dict, steps) -> dict:
        """Run the named broad-phase steps on the state `st` in order ->
        the state with every step's entries added."""
        for name in steps:
            st = {**st, **getattr(self, "_step_" + name)(st)}
        return st

    def _step_aabb(self, st):
        """vertices [B, V, 3] -> amin, amax [B, F, 3]: each face's AABB."""
        tris = st["vertices"].detach()[:, self.faces]       # [B, F, 3, 3]
        return {"amin": tris.amin(dim=2), "amax": tris.amax(dim=2)}

    def _step_morton_sort(self, st):
        """-> order [B, F], the permutation by the Morton code of each
        AABB centroid (stable sort: equal codes keep face order, as
        jnp.argsort), and sorted_pack [B, F, 3], the faces in that order."""
        cent = 0.5 * (st["amin"] + st["amax"])              # [B, F, 3]
        lo = cent.amin(dim=1, keepdim=True)
        span = torch.clamp(cent.amax(dim=1, keepdim=True) - lo, min=1e-9)
        qc = torch.clamp((cent - lo) / span * 1023.0, 0.0, 1023.0)
        qi = qc.to(torch.int64)
        code = (_interleave3(qi[..., 0]) | (_interleave3(qi[..., 1]) << 1)
                | (_interleave3(qi[..., 2]) << 2))
        order = torch.argsort(code, dim=-1, stable=True)
        return {"order": order, "sorted_pack": self.faces[order]}

    def _step_sorted_tables(self, st):
        """-> the funnel's inputs at `order`, padded to Fp: amin_s, amax_s
        [B, Fp, 3] and segm_sp, parents_sp [B, Fp] (None without parts)."""
        amin, order = st["amin"], st["order"]
        B = amin.shape[0]
        pad = self.Fp - self.F
        cols = [amin, st["amax"]]
        if self.segm is not None:
            cols += [self.segm[:self.F, None].expand(B, self.F, 1),
                     self.parents[:self.F, None].expand(B, self.F, 1)]
        packed = _rows(torch.cat(cols, dim=-1), order)      # [B, F, 6 or 8]
        big = packed.new_full((B, pad, 3), _BIG)
        out = {"amin_s": torch.cat([packed[..., 0:3], big], dim=1),
               "amax_s": torch.cat([packed[..., 3:6], -big], dim=1),
               "segm_sp": None, "parents_sp": None}
        if self.segm is not None:
            out["segm_sp"] = torch.cat(
                [packed[..., 6], self.segm[self.F:].expand(B, pad)], dim=1)
            out["parents_sp"] = torch.cat(
                [packed[..., 7], self.parents[self.F:].expand(B, pad)], dim=1)
        return out

    def morton_order(self, vertices: torch.Tensor) -> torch.Tensor:
        """Morton rank of each triangle's AABB centroid -> permutation
        [B, F]."""
        return self.run_steps({"vertices": vertices},
                              ("aabb", "morton_sort"))["order"]

    def _step_level0(self, st):
        """Superblock all-pairs: -> block boxes bmin, bmax [B, nb, 3], the
        superblock-pair mask ms [B, ns, ns] and its first Ps pairs (si, sj,
        validS [B, Ps])."""
        amin_s = st["amin_s"]
        B = amin_s.shape[0]
        nb, ns = self.nb, self.ns
        spad = self.nbp - nb
        bmin = amin_s.reshape(B, nb, _BLK, 3).amin(dim=2)      # [B, nb, 3]
        bmax = st["amax_s"].reshape(B, nb, _BLK, 3).amax(dim=2)
        big = bmin.new_full((B, spad, 3), _BIG)
        smin = torch.cat([bmin, big], 1).reshape(B, ns, _SUP, 3).amin(dim=2)
        smax = torch.cat([bmax, -big], 1).reshape(B, ns, _SUP, 3).amax(dim=2)
        iu = torch.arange(ns, device=amin_s.device)
        ms = (iu[:, None] <= iu[None, :]).expand(B, ns, ns)
        for k in range(3):
            ms = ms & (smin[:, :, None, k] <= smax[:, None, :, k]) \
                & (smax[:, :, None, k] >= smin[:, None, :, k])
        posS, validS = _compact(ms.reshape(B, -1), self.Ps)
        return {"bmin": bmin, "bmax": bmax, "ms": ms, "si": posS // ns,
                "sj": posS % ns, "validS": validS}

    def _blk_mask(self, sup_tab, si_, sj_, valid_):
        """[B, N] superblock pairs -> [B, N, 64] surviving block pairs
        (AABB overlap, rank order, conservative uniform-part filter)."""
        nb = self.nb
        ii, jj = _pair_cols(sup_tab.device)
        ba_ = si_[..., None] * _SUP + ii
        bb_ = sj_[..., None] * _SUP + jj
        m = valid_[..., None] & (ba_ <= bb_) & (ba_ < nb) & (bb_ < nb)
        A_, B_ = _rows(sup_tab, si_), _rows(sup_tab, sj_)
        m = _overlap(m, A_, B_)
        if self.segm is not None:
            ua = _ea(A_[..., 48:56] > 0.5)
            ub = _eb(B_[..., 48:56] > 0.5)
            m = m & ~((ua & ub) & _rel_drop(
                self.ign, _ea(A_[..., 56:64]), _ea(A_[..., 64:72]),
                _eb(B_[..., 56:64]), _eb(B_[..., 64:72])))
        return m

    def _step_level1(self, st):
        """8x8 block refinement of the level-0 pairs on packed [B, ns, C*8]
        superblock rows -> hit_s [B, Ps] (a pair keeps a block pair), its
        first Phs pairs (si_h, sj_h) and their block masks mb_h
        [B, Phs, 64]."""
        bmin, bmax = st["bmin"], st["bmax"]
        B, nb = bmin.shape[0], self.nb
        spad = self.nbp - nb

        def sup_rows(col):                                  # [B, nb] -> [B, ns, 8]
            return torch.cat([col, col[:, -1:].expand(B, spad)], 1) \
                .reshape(B, self.ns, _SUP)

        sup_cols = [sup_rows(bmin[..., k]) for k in range(3)] \
            + [sup_rows(bmax[..., k]) for k in range(3)]
        if self.segm is not None:
            sgb = st["segm_sp"].reshape(B, nb, _BLK)
            prb = st["parents_sp"].reshape(B, nb, _BLK)
            # uniform = one part and one parent across the block
            buni = ((sgb == sgb[..., :1]).all(-1)
                    & (prb == prb[..., :1]).all(-1))          # [B, nb]
            sup_cols += [sup_rows(buni.to(bmin.dtype)), sup_rows(sgb[..., 0]),
                         sup_rows(prb[..., 0])]
        sup_tab = torch.cat(sup_cols, dim=-1)               # [B, ns, C*8]
        mb = self._blk_mask(sup_tab, st["si"], st["sj"], st["validS"])
        hit_s = mb.any(dim=-1)                              # [B, Ps]
        posHS, validHS = _compact(hit_s, self.Phs)
        si_h = torch.gather(st["si"], 1, posHS)
        sj_h = torch.gather(st["sj"], 1, posHS)
        return {"hit_s": hit_s, "si_h": si_h, "sj_h": sj_h,
                "mb_h": self._blk_mask(sup_tab, si_h, sj_h, validHS)}

    def _level2_table(self, st):
        """The packed block rows blk_tab [B, nb, Cb*8], which the final
        step reads, and blk_tab8 [B, ns, 8*Cb*8], their superblock rows
        with the padding blocks' empty rows, which level 2 reads."""
        amin_s, amax_s = st["amin_s"], st["amax_s"]
        B, nb, ns, nbp = amin_s.shape[0], self.nb, self.ns, self.nbp
        with_parts = self.segm is not None
        blk_cols = [amin_s[..., k].reshape(B, nb, _BLK) for k in range(3)] \
            + [amax_s[..., k].reshape(B, nb, _BLK) for k in range(3)]
        if with_parts:
            blk_cols += [st["segm_sp"].reshape(B, nb, _BLK),
                         st["parents_sp"].reshape(B, nb, _BLK)]
        blk_tab = torch.cat(blk_cols, dim=-1)               # [B, nb, Cb*8]
        Cb = blk_tab.shape[-1] // _BLK
        empty_row = [_BIG] * 3 + [-_BIG] * 3 + ([-1.0, -3.0] if with_parts else [])
        empty = torch.tensor(empty_row, dtype=blk_tab.dtype,
                             device=amin_s.device).repeat_interleave(_BLK)
        blk_tab8 = torch.cat(
            [blk_tab, empty.expand(B, nbp - nb, Cb * _BLK)], dim=1
        ).reshape(B, ns, _SUP * Cb * _BLK)
        return blk_tab, blk_tab8

    def _step_level2(self, st):
        """Triangle-hit detection at superblock-pair granularity
        (`level2_hits`): which block pairs of the level-1 survivors carry
        >= 1 surviving triangle pair -> hit_bp [B, Phs, 64], and the packed
        block rows blk_tab [B, nb, Cb*8] the final step reads."""
        blk_tab, blk_tab8 = self._level2_table(st)
        return {"blk_tab": blk_tab,
                "hit_bp": level2_hits(blk_tab8, st["si_h"], st["sj_h"],
                                      st["mb_h"], self.ign)}

    def _tri_mask(self, blk_tab, bi_, bj_, valid_):
        """[B, N] block pairs -> [B, N, 64] surviving triangle pairs (AABB
        overlap, rank order, exact FilterFaces part test)."""
        ii, jj = _pair_cols(blk_tab.device)
        ra_ = bi_[..., None] * _BLK + ii
        rb_ = bj_[..., None] * _BLK + jj
        m = valid_[..., None] & (ra_ < rb_)
        A_, B_ = _rows(blk_tab, bi_), _rows(blk_tab, bj_)
        m = _overlap(m, A_, B_)
        if self.segm is not None:
            m = m & ~_rel_drop(
                self.ign, _ea(A_[..., 48:56]), _ea(A_[..., 56:64]),
                _eb(B_[..., 48:56]), _eb(B_[..., 56:64]))
        return m

    def _step_final(self, st):
        """The final compactions: hit-carrying rows, then block pairs, then
        triangle pairs -> the triangle masks mt_h [B, Ph, 64] and the first
        P pairs as sorted ranks (ra, rb, valid_t [B, P])."""
        hit_bp, si_h, sj_h = st["hit_bp"], st["si_h"], st["sj_h"]
        B, nb = hit_bp.shape[0], self.nb
        Phr = min(self.Ph, self.Phs)
        rowH, validRH = _compact(hit_bp.any(dim=-1), Phr)
        hit_rows = _rows(hit_bp, rowH) & validRH[..., None]  # [B, Phr, 64]
        posH, validH = _compact(hit_rows.reshape(B, -1), self.Ph)
        pih = torch.gather(rowH, 1, posH // 64)             # row of hit_bp
        wbh = posH % 64
        bi_h = torch.clamp(torch.gather(si_h, 1, pih) * _SUP + wbh // _SUP,
                           max=nb - 1)
        bj_h = torch.clamp(torch.gather(sj_h, 1, pih) * _SUP + wbh % _SUP,
                           max=nb - 1)
        mt_h = self._tri_mask(st["blk_tab"], bi_h, bj_h, validH)
        posT, validT = _compact(mt_h.reshape(B, -1), self.P)
        th, wt = posT // 64, posT % 64
        return {"mt_h": mt_h,
                "ra": torch.gather(bi_h, 1, th) * _BLK + wt // _BLK,
                "rb": torch.gather(bj_h, 1, th) * _BLK + wt % _BLK,
                "valid_t": validT}

    def _step_narrow_tris(self, st):
        """Deduplicate the 2P surviving ranks to <= T unique triangles,
        resolve their corner ids once, and store each pair side as an
        index into that list -> tri_corners [B, T, 3], pa, pb [B, P],
        valid [B, P] (pairs whose triangle overflows T drop) and n_tris [B],
        the distinct triangles."""
        ra, rb, valid = st["ra"], st["rb"], st["valid_t"]
        F, Fp, T = self.F, self.Fp, self.T
        ra_v = torch.where(valid, ra, Fp)                   # sentinel sorts last
        rb_v = torch.where(valid, rb, Fp)
        s = torch.sort(torch.cat([ra_v, rb_v], dim=1), dim=1).values
        is_new = torch.cat(
            [torch.ones_like(s[:, :1], dtype=torch.bool), s[:, 1:] != s[:, :-1]],
            dim=1) & (s < Fp)
        pos, uvalid = _compact(is_new, T)
        uniq = torch.where(uvalid, torch.gather(s, 1, pos), F - 1)   # [B, T]
        tri_corners = _rows(st["sorted_pack"], torch.clamp(uniq, max=F - 1))
        # Valid unique ranks are ascending, distinct and first; padding
        # above every rank keeps the row sorted for searchsorted, which
        # then finds the one equal entry (argmax of the equality in JAX).
        table = torch.where(uvalid, uniq, Fp + 1)

        def side_index(r):
            idx = torch.clamp(torch.searchsorted(table, r), max=T - 1)
            hit = torch.gather(table, 1, idx) == r
            return torch.where(hit, idx, 0), hit

        pa, ma = side_index(ra)
        pb, mb = side_index(rb)
        return {"tri_corners": tri_corners, "pa": pa, "pb": pb,
                "valid": valid & ma & mb, "n_tris": is_new.sum(dim=1)}

    def _step_row_plans(self, st):
        """-> aux: the `CollisionAux` of the broad phase (the row plans of
        its two gather levels)."""
        return {"aux": make_aux(st["tri_corners"], st["pa"], st["pb"],
                                st["valid"], st["order"], st["sorted_pack"])}

    @torch.no_grad()
    def candidate_pairs(self, vertices):
        """-> (idx_a [B, P], idx_b [B, P] face ids, valid [B, P])."""
        st = self.run_steps({"vertices": vertices},
                            self.BUILD_STEPS[:self.BUILD_STEPS.index("final") + 1])
        P = st["ra"].shape[1]
        oo = torch.gather(st["order"], 1, torch.clamp(
            torch.cat([st["ra"], st["rb"]], 1), max=self.F - 1))
        return oo[:, :P], oo[:, P:], st["valid_t"]

    @torch.no_grad()
    def saturation(self, vertices) -> dict:
        """Survivors against budgets at every level, {level: ([B], budget)},
        'narrow_tris' included.  A count equal to its budget means that
        level drops pairs for this pose."""
        st = self.run_steps({"vertices": vertices}, self.BUILD_STEPS[:-1])
        return {
            "superblock": (st["ms"].sum(dim=(1, 2)), self.Ps),
            "hit_superblock": (st["hit_s"].sum(dim=1), self.Phs),
            "hit": (st["hit_bp"].sum(dim=(1, 2)), self.Ph),
            "final": (st["mt_h"].sum(dim=(1, 2)), self.P),
            "narrow_tris": (st["n_tris"], self.T),
        }

    def _broad_phase(self, st: dict, steps, refresh: bool) -> CollisionAux:
        with timing.span("broad_phase", refresh=refresh) as sp:
            st = self.run_steps(st, steps)
            aux = st["aux"]
            if sp is not None:
                mb_h = st["mb_h"]
                sp.attrs.update(slots=aux.valid.numel(), live=aux.valid.sum(),
                                l2_slots=mb_h.shape[0] * mb_h.shape[1],
                                l2_skipped=(~mb_h.any(dim=-1)).sum())
        return aux

    @torch.no_grad()
    def build(self, vertices) -> CollisionAux:
        """Broad phase as a reusable aux, Morton order included."""
        return self._broad_phase({"vertices": vertices}, self.BUILD_STEPS,
                                 False)

    @torch.no_grad()
    def build_refresh(self, vertices, aux: CollisionAux) -> CollisionAux:
        """Broad phase under the previous aux's Morton order (no sort).
        The superblock level is all-pairs, so the result is exact up to the
        budgets for any order; a stale order only loosens the groupings."""
        st = {"vertices": vertices, "order": aux.order,
              "sorted_pack": aux.sorted_pack}
        return self._broad_phase(st, self.REFRESH_STEPS, True)

    # ---- narrow phase --------------------------------------------------

    def penalty(self, ta, tb, valid) -> torch.Tensor:
        """Cone penalty [B] of the pairs (ta, tb) [B, P, 3, 3] that are
        valid and whose AABBs overlap at these (detached) corners."""
        ta_s, tb_s = ta.detach(), tb.detach()
        live = valid
        for k in range(3):
            live = live & (tb_s[..., k].amin(-1) <= ta_s[..., k].amax(-1)) \
                & (tb_s[..., k].amax(-1) >= ta_s[..., k].amin(-1))
        pen = _cone_penalty_pairs(ta, tb, self.sigma, self.penalize_outside,
                                  point2plane=self.point2plane)
        return torch.sum(pen * live.to(pen.dtype), dim=-1)

    def apply(self, vertices, aux: CollisionAux) -> torch.Tensor:
        """Penalty [B] on a fixed pair list; differentiable in vertices."""
        ta, tb = _PairGather.apply(vertices, aux.corner_plan, aux.pair_plan)
        return segment("penalty", self.penalty, ta, tb, aux.valid)

    def __call__(self, vertices) -> torch.Tensor:
        return self.apply(vertices, self.build(vertices))


def make_collision_fn(
    faces,                                  # [F, 3] int tensor; its device is used
    segm: Optional[np.ndarray] = None,      # [F] part ids
    parents: Optional[np.ndarray] = None,   # [F] parent part ids
    ign_part_pairs: Sequence[str] = (),     # ["9,16", ...] reference format, <= 16
    max_pairs: int = 4096,
    max_sup_pairs: int = 8192,
    max_hit_sup_pairs: int = 4096,
    max_hit_pairs: int = 1024,
    max_tris: int = 2048,
    sigma: float = 1e-4,
    penalize_outside: bool = True,
    point2plane: bool = False,
) -> CollisionFn:
    """The collision term for a mesh topology, with the JAX package's
    budgets (its deprecated, ignored `window` and `max_block_pairs` are
    left out)."""
    return CollisionFn(faces, segm, parents, ign_part_pairs, max_pairs,
                       max_sup_pairs, max_hit_sup_pairs, max_hit_pairs,
                       max_tris, sigma, penalize_outside, point2plane)
