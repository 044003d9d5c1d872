"""Alignment and error metrics on tensors, batched over leading dimensions.

Counterpart of `smplifyx_tpu/evaluation/metrics.py` (reference
smplifyx/utils.py:540-801):
  * procrustes_align: the similarity transform (s, R, t) minimising
    ||s R S1 + t - S2|| by SVD, with the determinant-sign fix, so a
    reflection is never used;
  * scale_align: scale and translation only;
  * pelvis_align: subtract the mean of the hip joints;
  * mpjpe / v2v_error: per-point euclidean error;
  * procrustes_v2v: the error after Procrustes alignment (eval.py's
    metric);
  * point_fscore: precision, recall and F-score at a distance threshold,
    by exact nearest neighbours.

Every function takes [..., N, 3] points ([N, 3] or [B, N, 3] as in the
JAX package) and runs on the device of its inputs.  A 3x3 SVD per lane is
`torch.linalg.svd`; the rest are plain tensor ops.
"""

from __future__ import annotations

import torch

from smplifyx_torch.utils.device import full_f32_matmuls

# Elements of the [..., rows, M, 3] difference block that point_fscore
# holds at once (256 MB in f32): at V=10475 one full [N, M] distance matrix
# alone is 439 MB, so rows go in chunks.
FSCORE_BLOCK = 1 << 26


def _t(a) -> torch.Tensor:
    return torch.as_tensor(a)


def procrustes_align(S1, S2) -> torch.Tensor:
    """Similarity-align S1 [..., N, 3] onto S2 [..., N, 3]; returns the
    transformed S1."""
    S1, S2 = _t(S1), _t(S2)
    full_f32_matmuls()
    mu1 = S1.mean(-2, keepdim=True)
    mu2 = S2.mean(-2, keepdim=True)
    X1 = S1 - mu1
    X2 = S2 - mu2
    var1 = (X1 ** 2).sum((-2, -1))
    K = X1.transpose(-1, -2) @ X2                            # [..., 3, 3]
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).expand(K.shape).clone()
    Z[..., -1, -1] = torch.sign(torch.linalg.det(U @ Vh))
    R = V @ Z @ U.transpose(-1, -2)
    trace = torch.diagonal(R @ K, dim1=-2, dim2=-1).sum(-1)
    scale = (trace / torch.clamp(var1, min=1e-12))[..., None, None]
    Rt = R.transpose(-1, -2)
    t = mu2 - scale * (mu1 @ Rt)
    return scale * (S1 @ Rt) + t


def scale_align(S1, S2) -> torch.Tensor:
    """Scale and translate S1 to S2's spread and centroid."""
    S1, S2 = _t(S1), _t(S2)
    mu1 = S1.mean(-2, keepdim=True)
    mu2 = S2.mean(-2, keepdim=True)
    var1 = ((S1 - mu1) ** 2).sum((-2, -1))
    var2 = ((S2 - mu2) ** 2).sum((-2, -1))
    scale = torch.sqrt(var2 / torch.clamp(var1, min=1e-12))[..., None, None]
    return scale * S1 + (mu2 - scale * mu1)


def pelvis_align(joints, hips_idxs=(2, 3)) -> torch.Tensor:
    """Subtract the hips' mean (the 'pelvis') from [..., N, 3] joints."""
    joints = _t(joints)
    pelvis = joints[..., list(hips_idxs), :].mean(-2, keepdim=True)
    return joints - pelvis


def mpjpe(pred, gt) -> torch.Tensor:
    """Per-point euclidean error [..., N]."""
    return torch.sqrt(((_t(pred) - _t(gt)) ** 2).sum(-1))


v2v_error = mpjpe  # the same computation on vertices


def procrustes_v2v(pred, gt) -> torch.Tensor:
    """Per-point error after Procrustes alignment (the eval.py metric)."""
    return mpjpe(procrustes_align(pred, gt), gt)


def pelvis_mpjpe(pred, gt, hips_idxs=(2, 3)) -> torch.Tensor:
    return mpjpe(pelvis_align(pred, hips_idxs), pelvis_align(gt, hips_idxs))


def point_fscore(pred, gt, thresh: float) -> dict:
    """F-score at `thresh` between point sets [..., N, 3] and [..., M, 3]
    (exact nearest neighbours from difference-squared distances).

    As in the reference (utils.py:637-639) and the JAX package, pred->gt
    coverage is labelled 'recall' and gt->pred 'precision', the reverse of
    the usual convention; the F-score is symmetric."""
    pred, gt = _t(pred), _t(gt)
    lead = pred.shape[:-2]
    N, M = pred.shape[-2], gt.shape[-2]
    rows = max(1, FSCORE_BLOCK // (3 * M * max(1, lead.numel())))
    pred_to_gt = []
    gt_to_pred = None
    for lo in range(0, N, rows):
        d2 = ((pred[..., lo:lo + rows, None, :] - gt[..., None, :, :]) ** 2
              ).sum(-1)                                      # [..., rows, M]
        pred_to_gt.append(d2.amin(-1))
        col = d2.amin(-2)
        gt_to_pred = col if gt_to_pred is None else torch.minimum(gt_to_pred,
                                                                  col)
    pred_to_gt = torch.sqrt(torch.cat(pred_to_gt, -1))
    gt_to_pred = torch.sqrt(gt_to_pred)
    recall = (pred_to_gt < thresh).to(pred.dtype).mean(-1)
    precision = (gt_to_pred < thresh).to(pred.dtype).mean(-1)
    denom = recall + precision
    fscore = torch.where(
        denom > 0, 2 * recall * precision / torch.clamp(denom, min=1e-12),
        torch.zeros_like(denom))
    return {"fscore": fscore, "precision": precision, "recall": recall}
