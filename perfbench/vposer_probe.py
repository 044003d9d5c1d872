#!/usr/bin/env python3
"""Where the program's float32 fit departs from the plain float64
reference, frame by frame: every fitted frame of one run of a cell, under
a VPoser override or as the cell is.

    python3 perfbench/vposer_probe.py --workload combined-b128 --seed <n> \
        --seconds <s> [--plain] [--out <file.jsonl>] [--device cpu --tiny]

Runs the cell as `run_cell` does under `perfbench/tests/_vposer.py::VPOSER`
(`--plain`: without it; the window, the sample and the check unchanged),
keeps every fit's inputs, start, latents and recovered vertices, and
after the run reads for each fitted frame (the sampled ones marked):

  mesh_gap_mm      the recovered vertices against the reference's forward
                   at x, as the check reads it; body_gap_mm the same with
                   the program's decoded pose put into the reference's
                   forward (what is left is the body model's), and
                   plain32_gap_mm that pose through the reference's
                   forward in float32 against float64 (what float32 alone
                   rounds there);
  energy, energy0  the program's last-stage energy at x and at the fit's
                   start x0;
  extent_m, <segment>_max
                   the mesh's extent and the largest entry of each
                   parameter segment;
under VPoser also the largest |z| and |z|'s length (z0_norm at the
start), the largest decoded joint angle, the gap of the program's decode
from the reference's, split into the products' 6D output, the rotation
and the log map's own float32 error at the program's rotation, and the
smallest 6D column the Gram-Schmidt divides by.  For the frames of the
largest energy ratio x to x0, and a few of the median, the reference's
own energy at x and at x0 (ref_energy, ref_energy0) witnesses it.

Writes one JSON line a frame to `--out` and prints the run's result line,
then a summary.  Needs the program's device (a CUDA card by default).
The benchmark's own runs do not run this.
"""

import argparse
import json
import os.path as osp
import sys

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FAR = 20.0          # a latent's length past which a fit has run off


def float32_body(body):
    """A float32 copy of the reference's body model (no TF32): a second
    witness of what float32 alone rounds at given parameters."""
    import copy

    import torch

    out = copy.copy(body)
    for k, v in vars(body).items():
        if torch.is_tensor(v) and v.is_floating_point():
            setattr(out, k, v.float())
        elif isinstance(v, tuple) and all(torch.is_tensor(t) for t in v):
            setattr(out, k, tuple(t.float() if t.is_floating_point() else t
                                  for t in v))
    out.dtype = torch.float32
    return out


def decoded(program, reference, preset, x):
    """(the program's float32 body pose, the reference's float64 one, the
    decoder's readings) at x; without VPoser the pose is x's segment."""
    import torch

    from perfbench import reference as ref
    from smplifyx_torch.models import vposer as pv
    from smplifyx_torch.ops.rotation import rotmat_to_aa

    off, L = ref.layout(preset)["body"]
    z = x[:, off:off + L]
    dev = reference.device
    if not preset["use_vposer"]:
        return z.float().to(dev), z.to(dev, torch.float64), {}
    vp, rv = program.session.vposer, reference.vposer
    B, J = z.shape[0], rv.num_joints
    h = pv.leaky_relu(vp.bodyprior_dec_fc1(
        z.to(next(vp.parameters()).device, torch.float32)))
    h = pv.leaky_relu(vp.bodyprior_dec_fc2(h))
    six = vp.bodyprior_dec_out(h).reshape(B, J, 6)
    R = pv.rot6d_to_rotmat(six)
    pose = rotmat_to_aa(R).reshape(B, -1).to(dev)
    zd = z.to(dev, torch.float64)
    hd = ref.leaky_relu(rv._fc("bodyprior_dec_fc1", zd))
    hd = ref.leaky_relu(rv._fc("bodyprior_dec_fc2", hd))
    six_d = rv._fc("bodyprior_dec_out", hd).reshape(B, J, 6)
    R_d = ref.rot6d_to_rotmat(six_d)
    pose_d = ref.log_map(R_d).reshape(B, -1)
    log_own = (rotmat_to_aa(R).double().to(dev)
               - ref.log_map(R.double().to(dev)))
    a = six_d.reshape(B, J, 3, 2)
    a1, a2 = a[..., 0], a[..., 1]
    b1 = a1 / a1.norm(dim=-1, keepdim=True)
    perp = a2 - (b1 * a2).sum(-1, keepdim=True) * b1
    angle = pose_d.reshape(B, J, 3).norm(dim=-1)
    dec = (pose.double() - pose_d).abs().reshape(B, J, 3).amax(-1)
    worst = dec.argmax(-1)
    return pose, pose_d, dict(
        z_max=zd.abs().amax(-1), z_norm=zd.norm(dim=-1),
        angle_max=angle.amax(-1),
        angle_at_worst=angle.gather(1, worst[:, None])[:, 0],
        decode_gap=dec.amax(-1),
        six_gap=(six.double().to(dev) - six_d).abs().flatten(1).amax(-1),
        rot_gap=(R.double().to(dev) - R_d).abs().flatten(1).amax(-1),
        logmap_own_gap=log_own.abs().flatten(1).amax(-1),
        col_min=torch.minimum(a1.norm(dim=-1), perp.norm(dim=-1)).amin(-1))


def frame_readings(program, reference, body32, preset, x, vertices):
    """Per-frame readings {name: [B]} of x [B, D] and the program's
    recovered vertices [B, V, 3]."""
    import torch

    from perfbench import reference as ref

    with torch.no_grad():
        pose, pose_d, out = decoded(program, reference, preset, x)
        seg = ref.unpack(preset, x.to(reference.device, torch.float64))
        v_ref = reference.body.forward(ref.params_of(seg, pose_d))["vertices"]
        v_mix = reference.body.forward(ref.params_of(
            seg, pose.double()))["vertices"]
        v_32 = body32.forward(ref.params_of(
            {k: v.float() for k, v in seg.items()}, pose))["vertices"].double()
        vert = vertices.to(reference.device, torch.float64)
        out.update(
            mesh_gap_mm=1000.0 * (vert - v_ref).abs().flatten(1).amax(-1),
            body_gap_mm=1000.0 * (vert - v_mix).abs().flatten(1).amax(-1),
            plain32_gap_mm=1000.0 * (v_32 - v_mix).abs().flatten(1).amax(-1),
            extent_m=v_ref.abs().flatten(1).amax(-1),
            **{f"{k}_max": v.abs().amax(-1) for k, v in seg.items()
               if k != "body"})
    return {k: v.cpu().tolist() for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plain", action="store_true",
                    help="the cell as it is, without the VPoser override")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the tests' small sizes, for a CPU try")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from perfbench import cell as cellmod
    from perfbench import check
    from perfbench.manifest import Manifest
    from perfbench.tests._tiny import TINY
    from perfbench.tests._vposer import TINY_VPOSER, VPOSER

    overrides = ({"tiny": TINY, "cell": {}} if args.plain else
                 {"tiny": TINY_VPOSER, "cell": VPOSER})[
                     "tiny" if args.tiny else "cell"]
    kept = {"programs": [], "references": [], "fits": []}
    init, call, ref_init = (cellmod.Program.__init__, cellmod.Program.call,
                            check.Reference.__init__)

    def program_init(self, *a, **k):
        init(self, *a, **k)
        kept["programs"].append(self)

    def program_call(self, records, regression, session=None):
        prep, res, out = call(self, records, regression, session)
        if session is None:         # not the warm-up's short fit
            kept["fits"].append(dict(
                kp=np.stack([r.keypoints[0] for r in records]),
                reg=np.stack([g.body_pose for g in regression]),
                frames=prep.frames, x0=prep.x0.detach().clone(),
                x=res.x.detach().clone(), v=out.vertices.detach().clone()))
        return prep, res, out

    def reference_init(self, *a, **k):
        ref_init(self, *a, **k)
        kept["references"].append(self)

    cellmod.Program.__init__ = program_init
    cellmod.Program.call = program_call
    check.Reference.__init__ = reference_init
    m = Manifest()
    cell = m.workload(args.workload)
    out = cellmod.run_cell(m, cell, args.seed, args.seconds, False,
                           device=args.device, overrides=overrides)
    print(json.dumps(out["line"]), flush=True)

    conf = cellmod._merge(m.config(cell["config"]), overrides.get("config"))
    traffic = cellmod._merge(m.traffic(cell["traffic"]),
                             overrides.get("traffic"))
    preset = conf["preset"]
    program, reference = kept["programs"][0], kept["references"][0]
    B = traffic["frames_per_fit"]
    # The sample run_cell drew, by the same rule.
    n = len(kept["fits"]) * B
    rng = np.random.default_rng([int(args.seed) % (1 << 63), 4])
    picked = set(rng.choice(n, min(traffic["check_frames"], n),
                            replace=False).tolist())
    rows = []
    body32 = float32_body(reference.body)
    for k, f in enumerate(kept["fits"]):
        r = frame_readings(program, reference, body32, preset, f["x"], f["v"])
        r["energy"] = program.energy(f["frames"], f["x"])[0].cpu().tolist()
        r["energy0"] = program.energy(f["frames"], f["x0"])[0].cpu().tolist()
        if preset["use_vposer"]:
            with torch.no_grad():
                r["z0_norm"] = decoded(program, reference, preset, f["x0"])[2][
                    "z_norm"].cpu().tolist()
        for j in range(B):
            rows.append({"fit": k, "frame": j, "sampled": k * B + j in picked,
                         **{name: vals[j] for name, vals in r.items()}})
    # The reference's own energy at x and x0: the frames of the largest
    # ratio, and four about the median.
    ratio = sorted(range(len(rows)), key=lambda i: -rows[i]["energy"]
                   / max(rows[i]["energy0"], 1e-30))
    mid = len(ratio) // 2
    shown = ratio[:8] + ratio[max(mid - 2, 8):mid + 2]
    for i in shown:
        r, f = rows[i], kept["fits"][rows[i]["fit"]]
        j = r["frame"]
        for name, x in (("ref_energy", f["x"]), ("ref_energy0", f["x0"])):
            e = reference.evaluate(x[j:j + 1],
                                   torch.as_tensor(f["kp"][j:j + 1]),
                                   torch.as_tensor(f["reg"][j:j + 1]).double(),
                                   grad=False)
            r[name] = float(e["total"][0])
    if args.out:
        with open(args.out, "w") as fh:
            for row in rows:
                fh.write(json.dumps(row) + "\n")

    names = [k for k in rows[0] if k not in ("fit", "frame", "sampled")]
    summary = {"seed": args.seed, "fits": len(kept["fits"]), "frames": len(rows),
               "checks": {k: c["value"] for k, c in out["checks"].items()},
               "energy_median": float(np.median([r["energy"] for r in rows])),
               "energy0_median": float(np.median([r["energy0"] for r in rows])),
               "rose": sum(r["energy"] > r["energy0"] for r in rows),
               "max": {k: max(r[k] for r in rows) for k in names},
               "sampled_max": {k: max(r[k] for r in rows if r["sampled"])
                               for k in names}}
    if preset["use_vposer"]:
        far = [r for r in rows if r["z_norm"] > FAR]
        near = [r for r in rows if r["z_norm"] <= FAR]
        summary.update(
            far=len(far), far_energy_min=min((r["energy"] for r in far),
                                             default=None),
            near_mesh_gap_mm_max=max((r["mesh_gap_mm"] for r in near),
                                     default=None))
    print(json.dumps(summary), flush=True)
    for i in shown:
        print(json.dumps(rows[i]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
