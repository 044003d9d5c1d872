"""Narrow-phase row gather (K2) and sum-scatter (K3) and their plain versions.

    row_plan(ids [B, R])                                  -> plan [B, 3, R]
    gather_rows(table [B, N, C], ids [B, R])              -> [B, R, C]
    scatter_add_rows(ids [B, R] or plan [B, 3, R],
                     values [B, R, C], N)                 -> [B, N, C]

They replace the TPU kernels `smplifyx_tpu/ops/gather_pallas.py`
(`_gather_kernel` behind `gather_rows`, `_scatter_kernel` behind
`scatter_add_rows`), with the lane dimension that `vmap` adds there written
out.  On a CUDA tensor each wrapper launches its kernel in
`csrc/gather.cu` (see the note there for the bound and the design); on a
CPU tensor it takes its plain version, and only because the tensor lies on
the CPU.  There is no fallback: a CUDA tensor launches the kernel or
raises.  `gather_rows.launches` counts K2's launches;
`scatter_add_rows.launches` counts K3's first kernel (one per call) and
`scatter_add_rows.join_launches` its second, which runs when a lane's
positions span more than one tile; `row_plan.builds` counts plan builds.
Neither wrapper is differentiable by itself: the collision term's pair
gather (ops/collision.py) pairs them as forward and VJP.

A row plan holds a lane's ids as int32, the stable order that sorts them
and the sorted ids.  K3 reads it; the ids do not change between two broad
phases, so the collision term builds the plan once per broad phase, keeps
it as the only copy of the ids, and passes it to every launch in between.
"""

from __future__ import annotations

import ctypes

import torch

from smplifyx_torch.ops import nvcc

_I32_MAX = 2 ** 31 - 1
_MAX_C = 16         # K3's widest row (csrc/gather.cu MAX_C)
_MAX_LANES = 65535  # K2's and K3's grids take the lane from blockIdx.y
_ID_TYPES = (torch.int32, torch.int64)


def _load():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return nvcc.load("gather", {
        "gather_rows_forward": [p, p, i, ll, p, i, i, i, i, p],
        "scatter_add_rows_forward": [p, p, p, p, i, i, i, i, p],
        "scatter_add_rows_tiles": [i, i],
    })


def row_plan(ids: torch.Tensor) -> torch.Tensor:
    """ids [B, R] int32 or int64 -> the row plan [B, 3, R] int32, per lane:
    plan[:, 0] the ids (any id outside [0, 2^31) as -1, which K2 and K3
    treat as out of range), plan[:, 1] the stable order that sorts them,
    plan[:, 2] the sorted ids.  Every field is lane-local, so plans merge
    per lane like any [B, ...] tensor."""
    _check_ids("row_plan", ids)
    ids32 = torch.where((ids >= 0) & (ids <= _I32_MAX), ids, -1).to(torch.int32)
    sorted_ids, order = torch.sort(ids32, dim=1, stable=True)
    row_plan.builds += 1
    return torch.stack([ids32, order.to(torch.int32), sorted_ids], dim=1)


def gather_reference(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: advanced indexing, per lane."""
    lanes = torch.arange(table.shape[0], device=table.device)[:, None]
    return table[lanes, ids]


def scatter_add_reference(ids: torch.Tensor, values: torch.Tensor,
                          num_rows: int) -> torch.Tensor:
    """Plain version of K3: `index_add_` over lanes offset into one table."""
    B, R, C = values.shape
    offset = torch.arange(B, device=ids.device)[:, None] * num_rows
    out = values.new_zeros(B * num_rows, C)
    out.index_add_(0, (ids + offset).reshape(-1), values.reshape(B * R, C))
    return out.reshape(B, num_rows, C)


def _check_ids(name, ids, B=None):
    if ids.dtype not in _ID_TYPES:
        raise TypeError(f"{name}: ids are {ids.dtype}, expected int32 or int64")
    if ids.dim() != 2 or (B is not None and ids.shape[0] != B):
        raise ValueError(f"{name}: ids must be [B={B}, R], got {tuple(ids.shape)}")
    if ids.shape[1] > 1 and ids.stride(1) != 1:
        raise ValueError(f"{name}: each lane's ids must be contiguous")


def _check_values(name, t):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: values are {t.dtype}, expected float32")
    if t.dim() != 3:
        raise ValueError(f"{name}: expected a [B, rows, C] tensor, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: values must be contiguous")


def _device_of(name, *tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors lie on "
                         f"{[str(t.device) for t in tensors]}; they must share one")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _launch(name, fn, *args, dev):
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [B, N, C] f32, ids [B, R] int32 or int64 (each lane's row
    contiguous, e.g. a plan's `plan[:, 0]`) -> table[b, ids[b]] [B, R, C],
    bit-identical to indexing."""
    _check_values("gather_rows", table)
    B, N, C = table.shape
    _check_ids("gather_rows", ids, B)
    dev = _device_of("gather_rows", table, ids)
    if dev.type == "cpu":
        return gather_reference(table, ids)
    R = ids.shape[1]
    if B * R * C > _I32_MAX or B * N * C > _I32_MAX:
        raise ValueError("gather_rows: the kernel indexes below 2^31 elements")
    if B > _MAX_LANES:
        raise ValueError(f"gather_rows: the kernel takes at most {_MAX_LANES} "
                         f"lanes, got {B}")
    out = torch.empty(B, R, C, dtype=table.dtype, device=dev)
    _launch("gather", _load().gather_rows_forward, table.data_ptr(),
            ids.data_ptr(), ids.element_size(), ids.stride(0), out.data_ptr(),
            B, N, R, C, dev=dev)
    gather_rows.launches += 1
    return out


def _check_plan(plan, B, R):
    if plan.dtype != torch.int32 or tuple(plan.shape) != (B, 3, R):
        raise ValueError(f"scatter_add_rows: a plan must be [B={B}, 3, R={R}] "
                         f"int32, got {plan.dtype} {tuple(plan.shape)}")
    if not plan.is_contiguous():
        raise ValueError("scatter_add_rows: the plan must be contiguous")


def scatter_add_rows(ids: torch.Tensor, values: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """Sum-scatter values [B, R, C] f32 into [B, num_rows, C] at `ids`,
    adding duplicates.  `ids` is [B, R] (int32 or int64), or their row plan
    [B, 3, R] (`row_plan`), which the kernel reads: given ids, it builds the
    plan here.  On the card each row's entries add in an order fixed by the
    ids: the result is the same every run (C <= 16)."""
    _check_values("scatter_add_rows", values)
    B, R, C = values.shape
    if ids.dim() == 3:
        _check_plan(ids, B, R)
        plan, ids = ids, ids[:, 0]
    else:
        _check_ids("scatter_add_rows", ids, B)
        if ids.shape[1] != R:
            raise ValueError(f"scatter_add_rows: {ids.shape[1]} ids for {R} rows")
        plan = None
    dev = _device_of("scatter_add_rows", ids, values)
    if dev.type == "cpu":
        return scatter_add_reference(ids, values, num_rows)
    if B * R * C > _I32_MAX or B * num_rows * C > _I32_MAX:
        raise ValueError("scatter_add_rows: the kernel indexes below 2^31 "
                         "elements")
    if C > _MAX_C:
        raise ValueError(f"scatter_add_rows: the kernel takes rows of at most "
                         f"{_MAX_C} floats, got C={C}")
    if B > _MAX_LANES:
        raise ValueError(f"scatter_add_rows: the kernel takes at most "
                         f"{_MAX_LANES} lanes, got {B}")
    if plan is None:
        plan = row_plan(ids)
    lib = _load()
    tiles = lib.scatter_add_rows_tiles(R, C)
    out = torch.empty(B, num_rows, C, dtype=values.dtype, device=dev)
    part = torch.empty(B, tiles, 2, C, dtype=values.dtype, device=dev)
    _launch("scatter", lib.scatter_add_rows_forward, plan.data_ptr(),
            values.data_ptr(), out.data_ptr(), part.data_ptr(), B, R, C,
            num_rows, dev=dev)
    scatter_add_rows.launches += 1
    scatter_add_rows.join_launches += int(tiles > 1)
    return out


row_plan.builds = 0
gather_rows.launches = 0
scatter_add_rows.launches = 0
scatter_add_rows.join_launches = 0
