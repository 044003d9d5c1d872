"""Carry the JAX package's weights and state across to the port.

Each function takes one of the JAX package's objects as a dict of its
fields, with arrays given as numpy arrays and static fields as plain
values, and returns the port's object on `device`.  This module imports
no JAX: the caller does the `np.asarray`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from smplifyx_torch.fitting.energy import FrameData, StageWeights
from smplifyx_torch.fitting.params import FitSettings
from smplifyx_torch.models.bodymodel import SMPLXModel, model_from_arrays
from smplifyx_torch.models.sparse import JointsModel
from smplifyx_torch.priors.priors import GMMPrior
from smplifyx_torch.utils.device import resolve_device


def _tensor(a, dev):
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        return torch.as_tensor(a.astype(np.int64), device=dev)
    if a.dtype.kind == "b":
        return torch.as_tensor(a, device=dev)
    return torch.as_tensor(a.astype(np.float32), device=dev)


def _build(cls, fields: dict, device):
    dev = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(cls):
        v = fields[f.name]
        kw[f.name] = (_tensor(v, dev) if isinstance(v, (np.ndarray, np.generic))
                      else v)
    return cls(**kw)


def smplx_model(fields: dict, device="cuda") -> SMPLXModel:
    return model_from_arrays(fields, fields["parents"], device)


def joints_model(fields: dict, device="cuda") -> JointsModel:
    return _build(JointsModel, fields, device)


def gmm_prior(fields: dict, device="cuda") -> GMMPrior:
    return _build(GMMPrior, fields, device)


def stage_weights(fields: dict, device="cuda") -> StageWeights:
    return _build(StageWeights, fields, device)


def frame_data(fields: dict, device="cuda") -> FrameData:
    return _build(FrameData, fields, device)


def fit_settings(fields: dict) -> FitSettings:
    return FitSettings(**{f.name: fields[f.name]
                          for f in dataclasses.fields(FitSettings)})
