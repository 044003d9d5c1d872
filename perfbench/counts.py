"""Operations and bytes that the fit's work needs, from shapes alone, and
the published peaks they are held against.

A kernel's least time is the larger of its operations over the FP32 peak
and its bytes over the memory rate; each input byte is counted read once
and each output byte written once, whatever an implementation reads
again, and where the work depends on the data (sparse skinning weights)
the count is what these inputs need.
"""

from __future__ import annotations

# Published dense peaks of one card (NVIDIA's data sheet, SXM part, at the
# 700 W limit), by the name torch.cuda.get_device_name gives: FP32 outside
# the tensor cores (FLOP/s) and HBM (bytes/s).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"fp32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peak(device_name: str) -> dict | None:
    return PEAKS.get(device_name)


def least_s(ops: float, nbytes: float, pk: dict) -> float:
    return max(ops / pk["fp32_flops"], nbytes / pk["hbm_bytes"])


def lbs_counts(B: int, V: int, J: int, nnz: int) -> tuple[float, float]:
    """(operations, bytes) of skinning B lanes of V vertices with weights
    of nnz nonzeros: 12 multiply-adds per lane and nonzero weight to blend
    the transforms and 18 operations per vertex to apply them; A [B, J,
    16], the posed rest vertices and the output once, a 4-byte column and
    value per nonzero."""
    ops = 2.0 * B * nnz * 12 + 18.0 * B * V
    nbytes = 4.0 * (B * J * 16 + 2 * B * V * 3) + 8.0 * nnz
    return ops, nbytes


def scatter_counts(B: int, R: int, C: int, num_rows: int) -> tuple[float, float]:
    """(operations, bytes) of sum-scattering B lanes of R rows of C floats
    into num_rows rows: a 4-byte id per entry, the values read once, the
    output written once; one add per value."""
    return float(B * R * C), 4.0 * B * R + 4.0 * C * (B * R + B * num_rows)


def forward_flops(V: int, J: int, P: int, coeffs: int, nnz_w: int,
                  nnz_jreg: int, landmarks: int, keypoints: int) -> float:
    """Operations of one lane's full-mesh SMPL-X forward and projection:
    shape and expression blend (V x 3 x coeffs), joint regression (its
    nonzeros), pose correctives (P x V x 3), the kinematic chain (a 4x4
    product per joint), skinning (`lbs_counts`), barycentric landmarks and
    the pinhole projection of the keypoints."""
    return (2.0 * V * 3 * coeffs + 2.0 * nnz_jreg * 3 + 2.0 * P * V * 3
            + 128.0 * J + lbs_counts(1, V, J, nnz_w)[0]
            + 18.0 * landmarks + 10.0 * keypoints)


def joints_flops(S: int, J: int, P: int, coeffs: int, nnz_sub: int,
                 landmarks: int, keypoints: int) -> float:
    """Operations of one lane's joints-only forward: rest joints linear in
    the coefficients (J x 3 x coeffs), then the forward on the S vertices
    that the keypoints read."""
    return (2.0 * J * 3 * coeffs + 2.0 * S * 3 * coeffs + 2.0 * P * S * 3
            + 128.0 * J + lbs_counts(1, S, J, nnz_sub)[0]
            + 18.0 * landmarks + 10.0 * keypoints)
