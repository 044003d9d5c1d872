"""Linear-blend skinning: the hand-written CUDA kernel K1 and its plain version.

`lbs_apply(weights, A, v_posed, plan)` computes, for weights [V, J],
per-lane transforms A [B, J, 16] (row-major 4x4) and posed rest vertices
v_posed [B, V, 3]:

    T = weights @ A[b]                    # [V, 16]
    out[b, v] = T[v, 0:3, 0:3] v_posed[b, v] + T[v, 0:3, 3]

It replaces the TPU kernel `smplifyx_tpu/ops/lbs_pallas.py::_kernel`.  On
a CUDA tensor the forward is the kernel in `csrc/lbs.cu` (see the note
there for its bound on an H100 and what the design does about it); on a
CPU tensor it is `lbs_reference`, and only because the tensor lies on the
CPU.  There is no fallback: a CUDA tensor launches the kernel or raises.

The kernel reads W through its column plan (`lbs_plan`): per vertex the
columns of its nonzero weights in ascending order and their values,
padded to the widest row with entries of weight zero.  Skinning weights
are sparse (a few joints per vertex), so the kernel sums only those; a
skipped zero changes no bit of the sum while A is finite (an Inf or NaN
in A at a joint of weight zero reaches the dense sum, not this one).  The
models build their plans once (`SMPLXModel.lbs_plan`,
`JointsModel.lbs_plan`) and refuse a plan that is not their weights'
(`check_plan`): the kernel reads the plan, the backward and the CPU path
the weights.  Given no plan, `lbs_apply` builds one on the card.
`lbs_plan.builds` counts the builds.

The backward is the JAX package's `_bwd` in torch ops (`lbs_vjp`: rebuild
T, then dA = W^T dT and dv = R^T g); weights get no gradient, they are
model data.

The kernel is built with nvcc into `build/` at the repository root at
first use and loaded with ctypes (`ops/nvcc.py`).  `lbs_apply.launches`
counts launches, `lbs_apply.launches_by_rows` the same per vertex count V.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from smplifyx_torch.ops import nvcc
from smplifyx_torch.utils.tensors import TensorFields


def _load():
    p, i = ctypes.c_void_p, ctypes.c_int
    return nvcc.load("lbs", {"lbs_forward": [p] * 5 + [i] * 4 + [p],
                             "lbs_max_joints": []})


@dataclass(eq=False)
class LBSPlan(TensorFields):
    """Column plan of skinning weights [V, J]: per row the columns of its
    nonzero weights in ascending order, then columns of weight zero up to
    the widest row's count K (at least 1).  Two plans are equal when their
    tensors are."""

    cols: torch.Tensor  # [V, K] int32
    vals: torch.Tensor  # [V, K] f32, weights[v, cols[v]]

    def __eq__(self, other):
        return (isinstance(other, LBSPlan)
                and torch.equal(self.cols, other.cols)
                and torch.equal(self.vals, other.vals))


def _column_plan(weights: torch.Tensor) -> LBSPlan:
    V, J = weights.shape
    nonzero = weights != 0
    K = max(1, int(nonzero.sum(1).max())) if V else 1
    j = torch.arange(J, device=weights.device)
    # Nonzero columns first, each group in ascending order.
    key = torch.where(nonzero, j, j + J)
    cols = torch.sort(key, dim=1).values[:, :K] % J
    return LBSPlan(cols=cols.to(torch.int32).contiguous(),
                   vals=torch.gather(weights, 1, cols).contiguous())


def lbs_plan(weights: torch.Tensor) -> LBSPlan:
    """The column plan of weights [V, J], on their device."""
    lbs_plan.builds += 1
    return _column_plan(weights)


def check_plan(weights: torch.Tensor, plan: LBSPlan, owner: str) -> None:
    """Raise unless `plan` is `lbs_plan(weights)` (not counted as a build):
    a model's plan and weights must not drift apart."""
    same = (isinstance(plan, LBSPlan)
            and plan.cols.device == plan.vals.device == weights.device
            and plan == _column_plan(weights))
    if not same:
        raise ValueError(f"{owner}: lbs_plan is not the column plan of its "
                         "skinning weights; build it with lbs_plan(weights)")


def lbs_reference(weights: torch.Tensor, A: torch.Tensor,
                  v_posed: torch.Tensor) -> torch.Tensor:
    """Plain version: weights [V, J], A [B, J, 16], v_posed [B, V, 3] ->
    [B, V, 3] (the counterpart of lbs_pallas.py::_lbs_reference)."""
    T = torch.einsum("vj,bjk->bvk", weights, A)
    x, y, z = v_posed[..., 0], v_posed[..., 1], v_posed[..., 2]
    vx = T[..., 0] * x + T[..., 1] * y + T[..., 2] * z + T[..., 3]
    vy = T[..., 4] * x + T[..., 5] * y + T[..., 6] * z + T[..., 7]
    vz = T[..., 8] * x + T[..., 9] * y + T[..., 10] * z + T[..., 11]
    return torch.stack([vx, vy, vz], dim=-1)


def lbs_vjp(weights, A, v_posed, g, need_dA=True, need_dv=True):
    """(dA, dv) of sum(g * lbs_reference(weights, A, v_posed)); None for
    what is not needed."""
    dA = dv = None
    x, y, z = v_posed[..., 0], v_posed[..., 1], v_posed[..., 2]
    gx, gy, gz = g[..., 0], g[..., 1], g[..., 2]
    if need_dA:
        basis = torch.stack([x, y, z, torch.ones_like(x)], dim=-1)
        dT = torch.cat(
            [gx[..., None] * basis, gy[..., None] * basis,
             gz[..., None] * basis, torch.zeros_like(basis)], dim=-1,
        )                                            # [B, V, 16]
        dA = torch.einsum("vj,bvk->bjk", weights, dT)
    if need_dv:
        T = torch.einsum("vj,bjk->bvk", weights, A)
        dvx = T[..., 0] * gx + T[..., 4] * gy + T[..., 8] * gz
        dvy = T[..., 1] * gx + T[..., 5] * gy + T[..., 9] * gz
        dvz = T[..., 2] * gx + T[..., 6] * gy + T[..., 10] * gz
        dv = torch.stack([dvx, dvy, dvz], dim=-1)
    return dA, dv


def _check(weights, A, v_posed, plan):
    tensors = [weights, A, v_posed]
    if plan is not None:
        tensors += [plan.cols, plan.vals]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"lbs_apply: tensors on {[str(t.device) for t in tensors]}; "
            "they must share one device")
    if weights.device.type not in ("cpu", "cuda"):
        raise ValueError(f"lbs_apply: unsupported device {weights.device}")
    for name, t in (("weights", weights), ("A", A), ("v_posed", v_posed)):
        if t.dtype != torch.float32:
            raise TypeError(f"lbs_apply: {name} is {t.dtype}, expected float32")
        if not t.is_contiguous():
            raise ValueError(f"lbs_apply: {name} must be contiguous")
    if weights.dim() != 2 or A.dim() != 3 or v_posed.dim() != 3:
        raise ValueError("lbs_apply: expected weights [V, J], A [B, J, 16], "
                         "v_posed [B, V, 3]")
    V, J = weights.shape
    B = v_posed.shape[0]
    if tuple(A.shape) != (B, J, 16) or tuple(v_posed.shape) != (B, V, 3):
        raise ValueError(
            f"lbs_apply: shapes weights {tuple(weights.shape)}, A "
            f"{tuple(A.shape)}, v_posed {tuple(v_posed.shape)} do not agree"
        )
    if plan is not None:
        cols, vals = plan.cols, plan.vals
        if (cols.dtype != torch.int32 or vals.dtype != torch.float32
                or cols.dim() != 2 or cols.shape != vals.shape
                or cols.shape[0] != V or not 1 <= cols.shape[1] <= J):
            raise ValueError(
                f"lbs_apply: a plan of weights [{V}, {J}] is [V, K] int32 and "
                f"f32 with 1 <= K <= J, got {cols.dtype} {tuple(cols.shape)} "
                f"and {vals.dtype} {tuple(vals.shape)}")
        if not (cols.is_contiguous() and vals.is_contiguous()):
            raise ValueError("lbs_apply: the plan must be contiguous")


_max_joints: dict = {}     # device index -> lbs_max_joints() there


def _kernel_forward(plan, A, v_posed):
    """Launch K1 on the current stream (CUDA tensors only)."""
    B, J = A.shape[:2]
    V, K = plan.cols.shape
    lib = _load()
    if B * V * 3 >= 2 ** 31 or B * J * 16 >= 2 ** 31:
        raise ValueError("lbs kernel indexes below 2^31 elements")
    if any(t.data_ptr() % 16 for t in (A, v_posed, plan.cols, plan.vals)):
        raise ValueError("lbs kernel copies A, v_posed and the plan in 16-byte "
                         "words: they must start 16-byte aligned")
    out = torch.empty_like(v_posed)
    with torch.cuda.device(v_posed.device):
        limit = _max_joints.get(v_posed.device.index)
        if limit is None:
            limit = _max_joints[v_posed.device.index] = lib.lbs_max_joints()
        if J > limit:
            raise ValueError(f"lbs kernel takes J <= {limit} (its shared "
                             f"memory), got {J}")
        stream = torch.cuda.current_stream(v_posed.device).cuda_stream
        err = lib.lbs_forward(
            plan.cols.data_ptr(), plan.vals.data_ptr(), A.data_ptr(),
            v_posed.data_ptr(), out.data_ptr(), B, V, J, K, stream,
        )
    if err != 0:
        raise RuntimeError(f"lbs kernel launch failed: cudaError_t {err}")
    lbs_apply.launches += 1
    lbs_apply.launches_by_rows[V] = lbs_apply.launches_by_rows.get(V, 0) + 1
    return out


class _LBSFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, weights, A, v_posed, cols, vals):
        ctx.save_for_backward(weights, A, v_posed)
        if v_posed.device.type == "cpu":
            return lbs_reference(weights, A, v_posed)
        return _kernel_forward(LBSPlan(cols, vals), A, v_posed)

    @staticmethod
    def backward(ctx, g):
        weights, A, v_posed = ctx.saved_tensors
        dA, dv = lbs_vjp(weights, A, v_posed, g, ctx.needs_input_grad[1],
                         ctx.needs_input_grad[2])
        return None, dA, dv, None, None


def lbs_apply(weights: torch.Tensor, A: torch.Tensor, v_posed: torch.Tensor,
              plan: LBSPlan | None = None) -> torch.Tensor:
    """Skinned vertices [B, V, 3]; differentiable in A and v_posed.  `plan`
    is `lbs_plan(weights)`, which the kernel reads (built here on the card
    when not given; unused on the CPU)."""
    _check(weights, A, v_posed, plan)
    if plan is None:
        if weights.device.type == "cpu":
            return _LBSFunction.apply(weights, A, v_posed, None, None)
        plan = lbs_plan(weights)
    return _LBSFunction.apply(weights, A, v_posed, plan.cols, plan.vals)


lbs_plan.builds = 0
lbs_apply.launches = 0
lbs_apply.launches_by_rows = {}
