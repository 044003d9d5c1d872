"""How `correct` is decided: the program's outputs for a sample of the
frames it fitted in the window, judged by the plain reference
(reference.py) once the window has closed.

For each sampled frame the program answered with its fitted parameters x
(under VPoser the body segment is the latent, which the reference decodes
with its own VPoser from the same checkpoint) and the mesh and keypoints
it recovered from x; and, asked once the window has closed (still under
whatever runs the window), with the gradient at x of the last stage's
energy from its own energy function on the fit's whole batch, with a
broad phase at x: the data term through the camera, the priors, and the
self-collision term through the broad phase and kernels K2/K3.  The
numbers compared:

  mesh_gap_mm    the largest gap over the sample of the recovered vertices
                 from the reference's forward at x (shape, expression and
                 pose blends, joint regression, the kinematic chain,
                 skinning: kernel K1);
  joints_gap_mm  the same of the recovered keypoints (skeleton, vertex
                 joints, face and contour landmarks, joint map);
  grad_gap       the largest over the sample of the distance of the
                 program's gradient from the reference's, relative to the
                 length of the reference's; over the frames whose exact
                 collision pairs are within the configuration's
                 `max_coll_pairs` (past it the configuration has the
                 program score that many of them), and that have not
                 run off (below): a fit that ran off into deep
                 self-penetration holds pairs whose boxes barely touch and
                 whose cones carry 1e4-1e5 each, so that float32's
                 rounding alone moves its gradient by over 1e-2, and the
                 program's budgets below `max_coll_pairs` bind only in
                 such frames;
  reproj_px      per frame the mean distance of the reference's projected
                 keypoints at x from the frame's keypoints, over the
                 keypoints the last stage weighs, and of those the upper
                 quartile over the sampled frames that did not run off:
                 the fit's outcome against its input.

A frame has run off where its exact energy without the self-collision
term (the data term and the priors: how well it fits its keypoints and
stays plausible) exceeds `RUN_OFF` times the sample's median of the same
(interpolated, so that no frame of two can).  Some 7-10% of fitted frames
do, on every seed; a sample of 32 that holds eight of them would put the
upper quartile among them.  The collision term is left out of the rule
so that a broken collision term, which lets fits walk into each other,
does not take its own frames out of the gradient.  Every frame stays in
the mesh and keypoint gaps.

Read beside them and not compared: `over_budget`, the sampled frames past
`max_coll_pairs`, and `run_off`, the sampled frames that ran off.  The energy itself is not compared: at the frames left it
separates the control from sound runs by less than three times.

The reference runs in float64.  The control puts the reference, in float32
with TF32 products, in the program's place (`outputs`), and is read by
perfbench/control.py.  The configuration states the limits under
`correct_limits`, with the readings they were set from in PERF.md.
"""

from __future__ import annotations

import math

import torch

from perfbench import reference as ref

NAMES = ("mesh_gap_mm", "joints_gap_mm", "grad_gap", "reproj_px")
BLOCK = 8       # frames the reference holds at once
QUANTILE = 0.75
# A frame whose exact energy without the collision term exceeds this many
# times the sample's median of the same has run off.
RUN_OFF = 100.0


class Reference:
    """The reference of one configuration, built from the run's files."""

    def __init__(self, conf: dict, paths: dict, image_hw, device,
                 dtype=torch.float64, tf32: bool = False):
        self.preset = conf["preset"]
        self.image_hw = tuple(image_hw)
        H, W = self.image_hw
        self.focal = float(self.preset.get("focal_length")
                           or math.sqrt(W * W + H * H))
        model_cfg = {**conf["model"],
                     "num_pca_comps": self.preset["num_pca_comps"]}
        self.body = ref.Body(paths["model"], model_cfg, dtype, device, tf32)
        self.vposer = None
        if self.preset["use_vposer"]:
            self.vposer = ref.VPoser(paths["vposer"], dtype, device, tf32)
        self.collision = (ref.Collision(self.body.faces, paths["part_segm"],
                                        self.preset)
                          if self.preset["interpenetration"] else None)
        self.device = torch.device(device)

    def evaluate(self, x: torch.Tensor, kp: torch.Tensor, reg: torch.Tensor,
                 grad: bool = False) -> dict:
        """Energy (and its gradient), forward and projection at x [n, D]
        for keypoints [n, K, 3] and the regressor's poses [n, 63] (any
        device), in blocks."""
        outs = []
        for lo in range(0, x.shape[0], BLOCK):
            xb = x[lo:lo + BLOCK].to(self.device, self.body.dtype)
            xb.requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                e = ref.energy(self.body, self.preset, xb,
                               kp[lo:lo + BLOCK].to(self.device), self.focal,
                               self.image_hw, self.collision,
                               reg_body=reg[lo:lo + BLOCK],
                               vposer=self.vposer)
                g = (torch.autograd.grad(e["total"].sum(), xb)[0] if grad
                     else None)
            o = {k: e[k].detach() for k in ("total", "vertices", "joints",
                                            "proj", "weights", "pairs")}
            o["fit_energy"] = (e["total"] - e["terms"]["collision"]).detach()
            if grad:
                o["grad"] = g
            outs.append(o)
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    def outputs(self, x: torch.Tensor, kp: torch.Tensor,
                reg: torch.Tensor) -> dict:
        """What the program answers at x, computed by this reference: the
        control's outputs when the reference is the control."""
        e = self.evaluate(x, kp, reg, grad=True)
        return {"grad": e["grad"], "vertices": e["vertices"],
                "joints": e["joints"]}

    def gt_vertices(self, gt: dict) -> torch.Tensor:
        outs = []
        n = gt["cam_t"].shape[0]
        for lo in range(0, n, BLOCK):
            p = {k: v[lo:lo + BLOCK].to(self.device) for k, v in gt.items()
                 if k != "cam_t"}
            outs.append(self.body.forward(p)["vertices"])
        return torch.cat(outs)


def readings(reference: Reference, sample: dict, answers: dict) -> dict:
    """The numbers compared for one sample {x, keypoints, reg} and the
    answers {grad, vertices, joints} given for it, and `over_budget` and
    `run_off`."""
    e = reference.evaluate(sample["x"], sample["keypoints"], sample["reg"],
                           grad=True)
    dev, dt = e["vertices"].device, e["vertices"].dtype

    def gap(name):
        return (answers[name].to(dev, dt) - e[name]).abs().amax().item()

    kp = sample["keypoints"].to(dev, dt)
    dist = (e["proj"] - kp[..., :2]).norm(dim=-1)
    used = (e["weights"] > 0).to(dt)
    per_frame = (dist * used).sum(-1) / used.sum(-1).clamp_min(1)
    g = answers["grad"].to(dev, dt)
    # The configuration states that the program scores at most
    # `max_coll_pairs` pairs a frame: frames with more exact pairs than
    # that are left out of the gradient.  Frames that ran off are left out
    # of the gradient and the reprojection.
    within = (e["pairs"] <= reference.preset["max_coll_pairs"]).to(dev)
    fit = e["fit_energy"]
    settled = fit <= RUN_OFF * torch.quantile(fit, 0.5)
    grad_gap = ((g - e["grad"]).norm(dim=-1)
                / e["grad"].norm(dim=-1).clamp_min(1e-30))
    out = {
        "mesh_gap_mm": 1000.0 * gap("vertices"),
        "joints_gap_mm": 1000.0 * gap("joints"),
        "grad_gap": torch.where(within & settled, grad_gap, 0).amax().item(),
        "reproj_px": torch.quantile(per_frame[settled], QUANTILE).item(),
        "over_budget": int((~within).sum()),
        "run_off": int((~settled).sum()),
    }
    # A non-finite answer reads as infinitely far.
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}}).  A number
    without a limit fails."""
    checks = {n: {"value": values[n], "limit": limits.get(n)} for n in NAMES}
    ok = all(c["limit"] is not None and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
