"""The whole fit's share of the card's FP32 peak, in %, over the window's
untraced fits (the traced one is stretched by the profiler): the body
model's operations in every evaluation each fit made
(`FitResult.camera_evals`, `stage_evals`), each a forward and its gradient
(twice the forward's operations), on the keypoints' vertices outside the
collision stages and on the full mesh in them; plus the camera guess and
the recovered meshes; over the fits' seconds.  Where the preset tries both
orientations the body stages run both, and the program keeps only the
winner's counts: the other orientation's evaluations are taken equal to
the winner's, an approximation of the work."""

from perfbench import counts


def read(run):
    if run.peak is None or not run.untraced:
        return None
    s = run.shapes
    sub = counts.joints_flops(s["S"], s["J"], s["P"], s["coeffs"],
                              s["nnz_sub"], s["landmarks"], s["keypoints"])
    full = counts.forward_flops(s["V"], s["J"], s["P"], s["coeffs"],
                                s["nnz_w"], s["nnz_jreg"], s["landmarks"],
                                s["keypoints"])
    orient = 2 if s["both_orient"] else 1
    ops = seconds = 0.0
    for c in run.untraced:
        B = c["camera_evals"].shape[0]
        ops += B * sub + 2 * c["camera_evals"].sum() * sub
        for k, evals in enumerate(c["stage_evals"]):
            per = full if s["coll_stages"][k] else sub
            ops += orient * 2 * evals.sum() * per
        ops += B * full
        seconds += c["seconds"]
    return 100.0 * float(ops) / (seconds * run.peak["fp32_flops"])
