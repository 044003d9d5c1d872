"""One run of one cell: set-up, the measured window, the check of the
window's outputs against the plain reference, and the metrics.

Set-up (timed as `setup_s`, from the start of the process to the first
timed fit) draws the cell's body model (and VPoser, where the preset uses
one), frames and the regressors' estimates from the seed (generate.py),
writes the model as a user's files, loads it and builds the
fit session through the program's entry points, and warms up with one
short fit of the cell's own batch that runs every stage's code path.

The window repeats the user's call, closed loop, one caller: assemble the
batch from the frame records (`fitting/prepare.py::prepare_batch`), fit it
(`FitSession.fit`), recover the meshes (`fitting/pipeline.py::
recover_outputs`) and wait for the card.  Each repetition takes the next
frames of the pool drawn in set-up.  The fit that crosses the end of the
window is finished and counted, and the window ends with it.  A traced
run (`trace=True`) times one repetition under torch.profiler instead (and
the next, where the first one's trace lacks a mark).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import sys
import tempfile
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from perfbench import check, generate
from perfbench import reference as ref
from perfbench import trace as tr
from perfbench.counts import peak

# Fits traced at most in one run: a second where the first one's trace
# lacks a mark (trace.IncompleteTrace).
TRACE_ATTEMPTS = 2


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _merge(base: dict, extra: dict | None) -> dict:
    out = dict(base)
    for k, v in (extra or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and k in out else v
    return out


def model_shapes(body: ref.Body, preset: dict,
                 vposer: ref.VPoser | None = None) -> dict:
    """The shapes the operation counts read, worked out from the model
    file: vertex, joint, corrective and coefficient counts, the nonzeros
    of the skinning weights and the joint regressor, and the vertices the
    keypoints read (vertex joints and landmark triangles) with their
    skinning nonzeros; and from the VPoser checkpoint, if the preset uses
    one, the decoder's latent, hidden and joint counts (else None)."""
    faces = body.faces
    subset = torch.unique(torch.cat([
        body.extra_vids.reshape(-1), faces[body.lmk_faces].reshape(-1),
        faces[body.dyn_faces].reshape(-1)]))
    return dict(
        V=body.num_verts, J=len(body.parents), P=body.posedirs.shape[0],
        coeffs=body.dirs.shape[-1],
        nnz_w=int((body.weights != 0).sum()),
        nnz_jreg=int((body.J_regressor != 0).sum()),
        S=int(subset.numel()),
        nnz_sub=int((body.weights[subset] != 0).sum()),
        landmarks=int(body.lmk_faces.numel()
                      + body.dyn_faces.shape[1] * body.use_face_contour),
        keypoints=int(body.joint_map.numel()),
        both_orient=bool(preset["try_both_orient"]),
        coll_stages=[float(w) > 0 for w in preset["coll_loss_weights"]]
        if preset["interpenetration"] else
        [False] * len(preset["coll_loss_weights"]),
        vposer=None if vposer is None else dict(
            latent=vposer.latent_dim, hidden=vposer.hidden,
            joints=vposer.num_joints),
    )


class Program:
    """The program under test, built from the run's files through its
    public entry points."""

    def __init__(self, conf: dict, paths: dict, device):
        import smplifyx_torch.fitting.pipeline as pipeline
        import smplifyx_torch.fitting.prepare as prepare
        from smplifyx_torch.models.bodymodel import load_body_model
        from smplifyx_torch.models.sparse import build_joints_model
        from smplifyx_torch.session import build_fit_session
        from smplifyx_torch.utils.config import Config

        preset = dict(conf["preset"])
        unknown = set(preset) - {f.name for f in dataclasses.fields(Config)}
        if unknown:
            raise KeyError(f"the program's Config has no {sorted(unknown)}")
        preset["part_segm_fn"] = paths["part_segm"]
        if preset["use_vposer"]:
            preset["vposer_ckpt"] = paths["vposer"]
        self.cfg = Config(**preset).validate()
        self.device = torch.device(device)
        self.model = load_body_model(
            paths["model"], "smplx", num_betas=self.cfg.num_betas,
            num_expression_coeffs=self.cfg.num_expression_coeffs,
            num_pca_comps=self.cfg.num_pca_comps, device=self.device)
        self.session = build_fit_session(self.cfg, model=self.model,
                                         device=self.device)
        self.joints_model = build_joints_model(self.model)
        self.joint_weights = self.session.joint_weights()
        # Modules, not functions: their entries are looked up per call.
        self._pipeline, self._prep = pipeline, prepare
        self.recorder = None        # a trace.Recorder marks the spans

    def warm_session(self, iters: int):
        """The session with `iters` iterations per stage and a broad phase
        in every one: the same kernels, shapes and stages, briefly."""
        o = self.session.options
        options = dataclasses.replace(
            o, lbfgs=dataclasses.replace(o.lbfgs, max_iters=iters, aux_every=1),
            camera_lbfgs=dataclasses.replace(o.camera_lbfgs, max_iters=iters))
        return dataclasses.replace(self.session, options=options)

    def span(self, name):
        return (self.recorder.span(name) if self.recorder is not None
                else contextlib.nullcontext())

    def call(self, records, regression, session=None):
        """The user's call: prepare, fit, recover, wait for the card."""
        session = session or self.session
        with self.span("prepare"):
            prep = self._prep.prepare_batch(
                self.cfg, records, self.joint_weights, regression=regression,
                vposer=self.session.vposer, device=self.device)
        with self.span("fit"):
            res = session.fit(self.model, self.joints_model, prep.frames,
                              prep.x0)
        with self.span("recover"):
            out, _, _ = self._pipeline.recover_outputs(
                self.model, session.settings, res.x, session.decode_body,
                joint_map=session.joint_map, device=self.device)
        _sync(self.device)
        return prep, res, out

    def energy(self, frames, x):
        """The last stage's energy [B] and its gradient [B, D] at x from
        the program's energy function, with a broad phase at x."""
        s = self.session
        k = s.schedule.num_stages - 1
        x = x.detach().clone().requires_grad_(True)
        e = self._pipeline.smplify_energy(
            x, s.settings, self.model, frames, s.schedule.stage(k), k,
            s.schedule.num_stages, s.decode_body, s.joint_map, gmm=s.gmm,
            joints_model=self.joints_model, lhand_gmm=s.lhand_gmm,
            rhand_gmm=s.rhand_gmm, collision_fn=s.collision_for(self.model))
        g, = torch.autograd.grad(e.sum(), x)
        _sync(self.device)
        return e.detach(), g


def _records(kp: np.ndarray, reg: dict, image_hw, first: int):
    from smplifyx_torch.data.keypoints import FrameRecord
    from smplifyx_torch.data.regressors import RegressionPrior

    records = [FrameRecord(fn=f"frame_{first + i:06d}", img_path="",
                           keypoints=kp[i][None], img_size=tuple(image_hw))
               for i in range(len(kp))]
    regression = [RegressionPrior(body_pose=reg["body_pose"][i],
                                  global_orient=reg["global_orient"][i],
                                  init_translation=reg["cam_t"][i])
                  for i in range(len(kp))]
    return records, regression


def run_cell(manifest, cell: dict, seed: int, seconds: float, trace: bool,
             device="cuda", overrides: dict | None = None,
             t0: float | None = None, fault=None,
             control: bool = False) -> dict:
    """One run of `cell`; returns {line: the result line, info: a line of
    context, checks}.  `overrides` merges into the configuration and the
    traffic ({"config": {...}, "traffic": {...}}): the tests' small sizes.
    `fault` (perfbench/faults.py) breaks the program under the window and
    under the energy it is asked for after; `control` adds the control's
    readings on the same sample (`control`, perfbench/control.py)."""
    t0 = time.perf_counter() if t0 is None else t0
    overrides = overrides or {}
    conf = _merge(manifest.config(cell["config"]), overrides.get("config"))
    traffic = _merge(manifest.traffic(cell["traffic"]), overrides.get("traffic"))
    dev = torch.device(device)
    with tempfile.TemporaryDirectory(prefix="perfbench-") as tmp:
        return _run(manifest, cell, conf, traffic, seed, seconds, trace, dev,
                    tmp, t0, fault or contextlib.nullcontext(), control)


def _run(manifest, cell, conf, traffic, seed, seconds, trace, dev, tmp, t0,
         fault, control):
    preset, model_cfg = conf["preset"], conf["model"]
    H, W = traffic["image_hw"]
    focal = float(preset.get("focal_length") or math.sqrt(W * W + H * H))
    B, pool = traffic["frames_per_fit"], traffic["fit_pool"]

    # ---- set-up: files from the seed, the frames, the program
    tensors = generate.body_model(model_cfg, seed, dev)
    paths = generate.write_model(tensors, tmp)
    del tensors
    truth_vposer = None
    if preset["use_vposer"]:
        paths["vposer"] = generate.write_vposer(
            generate.vposer_params(conf["vposer"], preset["vposer_latent_dim"],
                                   seed, dev), tmp)
        truth_vposer = ref.VPoser(paths["vposer"], torch.float64, dev)
    truth_body = ref.Body(paths["model"], {**model_cfg, "num_pca_comps":
                                           preset["num_pca_comps"]},
                          torch.float64, dev)
    shapes = model_shapes(truth_body, preset, truth_vposer)
    gt = generate.ground_truth(traffic, pool * B, focal, seed, dev,
                               preset["num_pca_comps"], preset["num_betas"],
                               preset["num_expression_coeffs"], truth_vposer)
    kp = generate.keypoints(truth_body, gt, traffic, focal, (H, W), seed, dev)
    # The regressors' estimates as both sides read them: float32.
    reg = {k: v.float().cpu().numpy() for k, v in
           generate.regression(gt, traffic, seed, dev).items()}
    del truth_body, truth_vposer
    program = Program(conf, paths, dev)

    def records(i):
        lo = (i % pool) * B
        return _records(kp[lo:lo + B], {k: v[lo:lo + B] for k, v in reg.items()},
                        (H, W), i * B)

    if traffic["warmup_iters"] > 0:
        program.call(*records(0), program.warm_session(traffic["warmup_iters"]))
    _sync(dev)
    setup_s = time.perf_counter() - t0

    # ---- the window
    fits, failed = [], 0
    recorder, summary, read_s = tr.Recorder(), None, 0.0

    def call(i):
        nonlocal failed
        t = time.perf_counter()
        try:
            prep, res, out = program.call(*records(i))
            fits.append((i, prep, res, out, time.perf_counter() - t))
        except Exception:       # a fit that raises fails its frames
            traceback.print_exc(file=sys.stderr)
            failed += B

    with fault:
        start = time.perf_counter()
        traced_i, profiled = None, []
        if trace and dev.type == "cuda":
            # Untraced fits for the first half of the window, whose times
            # the metrics read (once CUPTI has started, every later fit is
            # slower too); then one fit under the profiler, and the next
            # one if its trace comes back without every mark.
            i = 0
            while i == 0 or time.perf_counter() - start < seconds / 2:
                call(i)
                i += 1
            while summary is None:
                recorder = tr.Recorder()
                recorder.prime(program.model.lbs_weights,
                               program.joints_model.sub_lbs)
                program.recorder = recorder
                with recorder.installed(program.session), \
                        torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
                    # The profiler's edges are uncertain (trace.SETTLE_S):
                    # a throwaway kernel, then the call well inside them.
                    torch.ones(1, device=dev).add_(1)
                    _sync(dev)
                    time.sleep(tr.SETTLE_S)
                    t_traced = time.perf_counter()
                    call(i)
                    window_s = time.perf_counter() - t_traced
                    time.sleep(tr.SETTLE_S)
                profiled.append(i)
                traced_i, i = i, i + 1
                program.recorder = None
                t_read = time.perf_counter()
                try:
                    summary = tr.read(prof, recorder.marks)
                except tr.IncompleteTrace as e:
                    if len(profiled) == TRACE_ATTEMPTS:
                        raise
                    print(f"perfbench: the trace of fit {traced_i}: {e}; "
                          "tracing the next fit", file=sys.stderr)
                del prof
                read_s += time.perf_counter() - t_read
        else:
            i = 0
            while True:
                call(i)
                i += 1
                if trace or time.perf_counter() - start >= seconds:
                    break
            window_s = time.perf_counter() - start
        attempted = i * B
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)

        # ---- a sample of the fitted frames, and the program's answers
        done = [(k, j) for k in range(len(fits)) for j in range(B)]
        rng = np.random.default_rng([int(seed) % (1 << 63), 4])
        pick = sorted(rng.choice(len(done), min(traffic["check_frames"],
                                                len(done)),
                                 replace=False)) if done else []
        energies = {}
        for k in sorted({done[p][0] for p in pick}):
            _, prep, res, _, _ = fits[k]
            energies[k] = program.energy(prep.frames, res.x)
    # A traced run's per-layer metrics read the traced fit, and the
    # untraced fits before it for their times.
    traced = [f for f in fits if f[0] == traced_i]
    untraced = [f for f in fits if f[0] not in profiled]

    def counters(of):
        return [dict(host_reads=res.host_reads,
                     stage_evals=res.stage_evals.cpu().numpy(),
                     camera_evals=res.camera_evals.cpu().numpy(), seconds=s)
                for _, _, res, _, s in of]

    for _, _, res, out, _ in fits:
        bad = ~(torch.isfinite(res.x).all(-1)
                & torch.isfinite(out.vertices).flatten(1).all(-1))
        failed += int(bad.sum())

    def take(get):
        return torch.stack([get(k, j) for k, j in (done[p] for p in pick)]
                           ).detach().cpu() if pick else None

    answers = {"grad": take(lambda k, j: energies[k][1][j]),
               "vertices": take(lambda k, j: fits[k][3].vertices[j]),
               "joints": take(lambda k, j: fits[k][3].joints[j])}
    rows = [(fits[done[p][0]][0] % pool) * B + done[p][1] for p in pick]
    gt_sample = {k: v[rows] for k, v in gt.items()}
    sample = {"x": take(lambda k, j: fits[k][2].x[j]),
              "keypoints": torch.as_tensor(kp[rows]) if pick else None,
              "reg": torch.as_tensor(reg["body_pose"][rows]).double()}
    run_counters = {"traced": counters(traced), "untraced": counters(untraced)}
    fits = traced = untraced = energies = program = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    reference = check.Reference(conf, paths, (H, W), dev)
    # A sample with a non-finite answer reads as infinitely far, and is
    # not handed to the reference (an SVD of NaN raises).
    if pick and all(bool(torch.isfinite(v).all())
                    for v in (sample["x"], *answers.values())):
        values = check.readings(reference, sample, answers)
        pa = ref.pa_v2v_mm(answers["vertices"].to(dev, torch.float64),
                           reference.gt_vertices(gt_sample)).cpu().numpy()
    else:
        values, pa = {n: math.inf for n in check.NAMES}, np.array([])
    ok, checks = check.verdict(values, conf.get("correct_limits", {}))
    controls = None
    if control and pick:
        low = check.Reference(conf, paths, (H, W), dev, torch.float32, tf32=True)
        controls = check.readings(reference, sample, low.outputs(
            sample["x"], sample["keypoints"], sample["reg"]))
    check_s = time.perf_counter() - t_check

    frames = attempted - failed
    # What the metrics' readers (perfbench/metrics/) read.
    run = SimpleNamespace(
        frames=len(run_counters["traced"]) * B if summary is not None
        else frames, frames_per_fit=B,
        window_s=window_s, setup_s=setup_s, trace=summary, recorder=recorder,
        counters=run_counters["traced"], untraced=run_counters["untraced"],
        shapes=shapes,
        peak=peak(torch.cuda.get_device_name(dev)) if dev.type == "cuda"
        else None)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in manifest.metrics(kind, cell["name"]):
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    if summary is not None:
        device.update(busy_s=summary["busy_s"], window_s=window_s)
    line = {"correct": bool(ok and failed == 0 and frames > 0),
            "attempted": attempted, "failed": failed, "metrics": metrics,
            "device": device}
    if summary is not None:
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = checks
    info = {"workload": cell["name"], "seed": seed, "fits": attempted // B,
            "frames": frames, "window_s": window_s, "setup_s": setup_s,
            "fit_s": [c["seconds"] for c in run_counters["traced"]
                      + run_counters["untraced"]],
            "sampled": len(pick), "pa_v2v_mm_median":
            float(np.median(pa)) if len(pa) else None,
            "host_reads": [c["host_reads"] for c in run_counters["traced"]
                           + run_counters["untraced"]],
            "over_budget": values.get("over_budget"),
            "run_off": values.get("run_off"),
            "trace_read_s": read_s, "check_s": check_s}
    if summary is not None:
        kernels = [tr.kernel_base(k[0]) for k in summary["kernels"]]
        info.update(k1_launches=[len(recorder.k1), kernels.count("lbs_kernel")],
                    k3_launches=[len(recorder.k3),
                                 kernels.count("k3_scatter_tiles")])
    return {"line": line, "info": info, "checks": checks, "control": controls,
            "values": values}
