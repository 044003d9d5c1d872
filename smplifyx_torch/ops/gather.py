"""Narrow-phase row gather (K2) and sum-scatter (K3) and their plain versions.

    gather_rows(table [B, N, C], ids [B, R])              -> [B, R, C]
    scatter_add_rows(ids [B, R], values [B, R, C], N)     -> [B, N, C]

They replace the TPU kernels `smplifyx_tpu/ops/gather_pallas.py`
(`_gather_kernel` behind `gather_rows`, `_scatter_kernel` behind
`scatter_add_rows`), with the lane dimension that `vmap` adds there written
out.  On a CUDA tensor each wrapper launches its kernel in
`csrc/gather.cu` (see the note there for the bound and the design); on a
CPU tensor it takes its plain version, and only because the tensor lies on
the CPU.  There is no fallback: a CUDA tensor launches the kernel or
raises.  `gather_rows.launches` and `scatter_add_rows.launches` count
launches.  Neither wrapper is differentiable by itself: the collision
term's pair gather (ops/collision.py) pairs them as forward and VJP.
"""

from __future__ import annotations

import ctypes

import torch

from smplifyx_torch.ops import nvcc

_I32_MAX = 2 ** 31 - 1
_MAX_C = 16     # K3's widest row (csrc/gather.cu MAX_C)


def _load():
    p, i = ctypes.c_void_p, ctypes.c_int
    return nvcc.load("gather", {
        "gather_rows_forward": [p, p, p, i, i, i, i, p],
        "scatter_add_rows_forward": [p, p, p, p, i, i, i, i, p],
    })


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


def _check_ids(name, ids, B):
    if ids.dtype != torch.int64:
        raise TypeError(f"{name}: ids are {ids.dtype}, expected int64")
    if ids.dim() != 2 or ids.shape[0] != B:
        raise ValueError(f"{name}: ids must be [B={B}, R], got {tuple(ids.shape)}")
    if not ids.is_contiguous():
        raise ValueError(f"{name}: ids must be contiguous")


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


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table [B, N, C] f32, ids [B, R] int64 -> table[b, ids[b]] [B, R, C],
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
    out = torch.empty(B, R, C, dtype=table.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _load().gather_rows_forward(table.data_ptr(), ids.data_ptr(),
                                          out.data_ptr(), B, N, R, C, stream)
    if err != 0:
        raise RuntimeError(f"gather kernel launch failed: cudaError_t {err}")
    gather_rows.launches += 1
    return out


def scatter_add_rows(ids: torch.Tensor, values: torch.Tensor,
                     num_rows: int) -> torch.Tensor:
    """Sum-scatter values [B, R, C] f32 into [B, num_rows, C] at ids
    [B, R] int64, adding duplicates.  On the card the ids are sorted per
    lane (stable) and the kernel sums each row's segment in a fixed order:
    the result is the same every run (C <= 16)."""
    _check_values("scatter_add_rows", values)
    B, R, C = values.shape
    _check_ids("scatter_add_rows", ids, B)
    if ids.shape[1] != R:
        raise ValueError(f"scatter_add_rows: {ids.shape[1]} ids for {R} rows")
    dev = _device_of("scatter_add_rows", ids, values)
    if dev.type == "cpu":
        return scatter_add_reference(ids, values, num_rows)
    if B * R * C > _I32_MAX or B * num_rows * C > _I32_MAX:
        raise ValueError("scatter_add_rows: the kernel indexes below 2^31 "
                         "elements")
    if C > _MAX_C:
        raise ValueError(f"scatter_add_rows: the kernel takes rows of at most "
                         f"{_MAX_C} floats, got C={C}")
    sorted_ids, perm = torch.sort(ids, dim=1, stable=True)
    out = torch.empty(B, num_rows, C, dtype=values.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _load().scatter_add_rows_forward(
            sorted_ids.data_ptr(), perm.data_ptr(), values.data_ptr(),
            out.data_ptr(), B, R, C, num_rows, stream)
    if err != 0:
        raise RuntimeError(f"scatter kernel launch failed: cudaError_t {err}")
    scatter_add_rows.launches += 1
    return out


gather_rows.launches = 0
scatter_add_rows.launches = 0
