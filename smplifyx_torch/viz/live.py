"""During-fit result streaming: one fit call per stage -> per-stage pickles.

Counterpart of `smplifyx_tpu/viz/live.py`.  With `visualize`, the
reference renders the mesh inside the optimisation loop through its live
MeshViewer thread (fit_single_frame.py:509-520, mesh_viewer.py:82-97).
Here "live" is stage-granular: `stream_fit` drives `FitSession.fit_stages`
(one call per stage) and rewrites each frame's result pickle, with the
snapshots so far under the standard "stages" key, as each stage returns.
Point `python -m smplifyx_torch.viz.viewer --results <out_dir> --live` at
the same directory and the WebGL page refreshes as each stage lands.
"""

from __future__ import annotations

import os
import os.path as osp

import torch

from smplifyx_torch.fitting.params import unpack
from smplifyx_torch.utils.io import PARAM_KEYS, save_result_pickle, stage_record


def stream_fit(sess, model, joints_model, prepared, out_dir: str):
    """Fit stage by stage, writing the results after every stage.

    sess: FitSession; prepared: a PreparedBatch (fitting/prepare.py).
    Yields (stage, FitResult) after each stage's fit, once
    `<out_dir>/<name>/000.pkl` of every real frame holds the current
    parameters and the snapshots so far under "stages" (what
    viz/viewer.py --stages and --live read).  The last pickle is a
    complete result.
    """
    n = len(prepared.names)
    center = prepared.frames.center[:n].cpu().numpy()
    stages_acc: list[list[dict]] = [[] for _ in prepared.names]
    for stage, res in sess.fit_stages(model, joints_model, prepared.frames,
                                      prepared.x0):
        with torch.no_grad():
            seg = unpack(sess.settings, res.x[:n])
            body_pose = sess.decode_body(seg["body"]).cpu().numpy()
        seg = {k: v.cpu().numpy() for k, v in seg.items()}
        losses = res.loss[:n].cpu().numpy()
        for i, name in enumerate(prepared.names):
            stages_acc[i].append(stage_record(seg, body_pose, i))
            frame_dir = osp.join(out_dir, name)
            os.makedirs(frame_dir, exist_ok=True)
            save_result_pickle(
                osp.join(frame_dir, "000.pkl"),
                camera_translation=seg["cam_t"][i],
                camera_center=center[i], focal_length=prepared.focals[i],
                H=prepared.img_sizes[i][0], W=prepared.img_sizes[i][1],
                params={key: seg[s][i] for key, s in PARAM_KEYS.items()},
                body_pose=body_pose[i], loss=float(losses[i]),
                stages=stages_acc[i],
            )
        yield stage, res
