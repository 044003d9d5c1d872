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
from smplifyx_torch.models.sparse import JointsModel, landmark_tables
from smplifyx_torch.models.vposer import VPoser, vposer_from_state_dict
from smplifyx_torch.ops.collision import CollisionAux, make_aux
from smplifyx_torch.ops.lbs import lbs_plan
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
    """SMPLXModel with the column plan of its skinning weights."""
    return model_from_arrays(fields, fields["parents"], device)


def joints_model(fields: dict, device="cuda") -> JointsModel:
    """JointsModel with the column plan of its subset's skinning weights,
    its landmark triangles in SMPLXModel's layout (models/sparse.py)."""
    dev = resolve_device(device)
    plan = lbs_plan(_tensor(fields["sub_lbs"], dev))
    tables = landmark_tables(_tensor(fields["lmk_tri_sub"], dev),
                             _tensor(fields["dyn_tri_sub"], dev))
    return _build(JointsModel, {
        **fields, **tables, "lbs_plan": plan,
        "extra_joint_vids": fields["extra_idx"],
        "lmk_bary_coords": fields["lmk_bary"],
        "dyn_lmk_bary_coords": fields["dyn_bary"]}, dev)


def gmm_prior(fields: dict, device="cuda") -> GMMPrior:
    return _build(GMMPrior, fields, device)


def stage_weights(fields: dict, device="cuda") -> StageWeights:
    return _build(StageWeights, fields, device)


def frame_data(fields: dict, device="cuda") -> FrameData:
    return _build(FrameData, fields, device)


def fit_settings(fields: dict) -> FitSettings:
    return FitSettings(**{f.name: fields[f.name]
                          for f in dataclasses.fields(FitSettings)})


def vposer(params: dict, device="cuda") -> VPoser:
    """The JAX package's VPoser parameter tree (numpy leaves:
    decoder/encoder {name: {kernel, bias} or {scale, bias}}, encoder_stats
    {name: {mean, var}}) -> the port's VPoser.  A flax Dense kernel is
    [in, out]; a torch Linear weight is [out, in]."""
    sd = {}
    for part, prefix in (("decoder", "bodyprior_dec_"),
                         ("encoder", "bodyprior_enc_")):
        for name, leaves in params[part].items():
            if "kernel" in leaves:
                sd[prefix + name + ".weight"] = np.asarray(leaves["kernel"]).T
            else:
                sd[prefix + name + ".weight"] = np.asarray(leaves["scale"])
            sd[prefix + name + ".bias"] = np.asarray(leaves["bias"])
    for name, stats in params["encoder_stats"].items():
        sd[f"bodyprior_enc_{name}.running_mean"] = np.asarray(stats["mean"])
        sd[f"bodyprior_enc_{name}.running_var"] = np.asarray(stats["var"])
    return vposer_from_state_dict(sd, device)


def collision_aux(aux: tuple, device="cuda") -> CollisionAux:
    """A batched JAX collision aux (numpy): (tri_corners [B, T, 3],
    (pa, pb) [B, P], valid [B, P], order [B, F], sorted_pack [B, F, 3]
    f32) -> the port's CollisionAux: the narrow phase's ids in the row plans
    of its two gather levels, the Morton order and faces as int64."""
    dev = resolve_device(device)
    tri_corners, (pa, pb), valid, order, sorted_pack = aux

    def ids(a):
        return torch.as_tensor(np.asarray(a).astype(np.int64), device=dev)

    return make_aux(
        tri_corners=ids(tri_corners), pa=ids(pa), pb=ids(pb),
        valid=torch.as_tensor(np.array(valid, bool), device=dev),
        order=ids(order), sorted_pack=ids(sorted_pack))
