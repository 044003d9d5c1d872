"""Device meshes for batched fitting: frames over worker processes,
vertices over devices.

Counterpart of `smplifyx_tpu/parallel/mesh.py`, with its names and
signatures.  A mesh is a grid of torch devices, [n_data][n_model]:

  * **data**: frames are independent problems.  `fit_batch_sharded`
    starts one worker process per data row (spawn), which fits its
    contiguous block of frames with `fitting/pipeline.py::fit_batch` on
    its row's devices; the caller joins the results in frame order.
    Processes, not threads: the fit is bound by its host work (launches
    and host reads), which one interpreter's lock would serialise.
  * **model**: `shard_model` splits the vertices into n_model contiguous
    blocks, one per device of a row.  `smplx_forward` runs each block's
    shape and pose blends and its skinning (kernel K1) where the block
    lives, adds the blocks' partial joint regressions on the lead device
    in block order (the all-reduce that XLA's partitioner inserts in JAX),
    sends the joint transforms to every block and joins the skinned
    blocks on the lead device (the all-gather).  Gradients cross devices
    through autograd's `.to`.

`replicate`, `shard_frames` and `shard_model` return one entry per data
row, on that row's devices.  A device list may repeat a device:
["cuda:0", "cuda:0"] gives two workers on one card.  With no devices
given, a mesh takes every CUDA card and raises without one; it uses the
CPU only when the caller passes CPU devices.

A model moved to a device (`to_device`, `replicate`, a worker) gets the
K1 column plan of its skinning weights built there, and so does each
vertex block of `shard_model`; no plan of another device is reused.
"""

from __future__ import annotations

import copy
import dataclasses
import pickle
import time
import traceback
import types
from dataclasses import dataclass
from multiprocessing.connection import wait

import torch

from smplifyx_torch.fitting.pipeline import FitResult, fit_batch
from smplifyx_torch.models.bodymodel import SMPLXModel
from smplifyx_torch.ops import collision, gather, lbs
from smplifyx_torch.ops.gather import gather_rows, scatter_add_rows
from smplifyx_torch.ops.lbs import LBSPlan, check_plan, lbs_apply, lbs_plan
from smplifyx_torch.utils.device import resolve_device
from smplifyx_torch.utils.tensors import TensorFields

# The SMPLXModel fields that shard_model splits, with their vertex dim
# (posedirs: its V * 3 output columns); each block gets its own lbs_plan,
# and the other fields are replicated on the lead device.
_VERTEX_DIM = {"v_template": 0, "shapedirs": 0, "exprdirs": 0,
               "posedirs": 1, "J_regressor": 1, "lbs_weights": 0}


@dataclass(frozen=True)
class Mesh:
    """A ("data", "model") grid of torch devices, [n_data][n_model]."""

    devices: tuple

    @property
    def shape(self) -> dict:
        return {"data": len(self.devices), "model": len(self.devices[0])}

    @property
    def lead(self) -> torch.device:
        """The first row's first device, where results are joined."""
        return self.devices[0][0]


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(n_data: int | None = None, n_model: int = 1,
              devices=None) -> Mesh:
    """A ("data", "model") mesh of the first n_data * n_model `devices`
    (default: every CUDA card); n_data defaults to all of them on the
    data axis."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_data is None:
        n_data = len(devices) // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model > len(devices):
        raise ValueError(f"make_mesh: a {n_data}x{n_model} mesh needs "
                         f"{n_data * n_model} devices, got {len(devices)}")
    return Mesh(tuple(tuple(devices[r * n_model:(r + 1) * n_model])
                      for r in range(n_data)))


def to_device(tree, device):
    """A copy of `tree` on `device`: tensors, dataclasses of them (a body
    or joints model with a column plan built there), modules (copied),
    bound methods (of a moved copy of their object), objects with a
    `.to(device)` (the collision term) and lists, tuples and dicts of
    these.  Anything else is returned as it is."""
    dev = torch.device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev)
    if isinstance(tree, ShardedModel):
        raise TypeError("a vertex-sharded model stays on its devices; move "
                        "the model before shard_model")
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = {f.name: getattr(tree, f.name)
                  for f in dataclasses.fields(tree) if f.init}
        moved = {k: to_device(v, dev) for k, v in fields.items()
                 if not isinstance(v, LBSPlan)}
        if len(moved) == len(fields):
            return dataclasses.replace(tree, **moved)
        weights = moved["sub_lbs" if "sub_lbs" in moved else "lbs_weights"]
        return type(tree)(**moved, lbs_plan=lbs_plan(weights))
    if isinstance(tree, torch.nn.Module):
        return copy.deepcopy(tree).to(dev)
    if isinstance(tree, types.MethodType):
        return types.MethodType(tree.__func__, to_device(tree.__self__, dev))
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, dev) for v in tree)
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if callable(getattr(tree, "to", None)) and not isinstance(tree, type):
        return tree.to(dev)
    return tree


def _map_tensors(tree, fn):
    """`tree` with fn applied to every tensor (in dataclasses, lists,
    tuples and dicts)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, TensorFields):
        return tree.map(fn)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return tree


def _batch_size(tree) -> int:
    sizes = set()
    _map_tensors(tree, lambda t: sizes.add(t.shape[0]) or t)
    if len(sizes) != 1:
        raise ValueError(f"shard_frames: leading dims {sorted(sizes)} differ")
    return sizes.pop()


def _split(tree, devices) -> list:
    """Contiguous blocks of the leading dim of every tensor in `tree`, one
    copied to each of `devices`."""
    n, B = len(devices), _batch_size(tree)
    if B % n:
        raise ValueError(f"shard_frames: {B} frames do not divide over "
                         f"{n} data rows")
    b = B // n
    return [_map_tensors(tree, lambda t, r=r: t[r * b:(r + 1) * b].detach()
                         .to(dev, copy=True)) for r, dev in enumerate(devices)]


def replicate(tree, mesh: Mesh) -> list:
    """One copy of `tree` per data row, on the row's lead device."""
    return [to_device(tree, row[0]) for row in mesh.devices]


def shard_frames(tree, mesh: Mesh) -> list:
    """The leading (batch) dim of every tensor in `tree` split into
    contiguous blocks, one per data row, on the row's lead device.  The
    batch must divide by n_data."""
    return _split(tree, [row[0] for row in mesh.devices])


@dataclass
class ModelBlock(TensorFields):
    """The vertex-dependent tensors of one contiguous block of vertices."""

    v_template: torch.Tensor    # [Vb, 3]
    shapedirs: torch.Tensor     # [Vb, 3, K]
    exprdirs: torch.Tensor      # [Vb, 3, E]
    posedirs: torch.Tensor      # [P, Vb * 3]
    J_regressor: torch.Tensor   # [J, Vb] (its partial joint regression)
    lbs_weights: torch.Tensor   # [Vb, J]
    lbs_plan: LBSPlan           # column plan of lbs_weights, built on its device

    def __post_init__(self):
        check_plan(self.lbs_weights, self.lbs_plan, "ModelBlock")


@dataclass
class ShardedModel:
    """A body model whose vertices are split into blocks, one per device
    (`shard_model`); the index tables and hand spaces are replicated on
    the lead device.  `smplx_forward` takes it where it takes an
    SMPLXModel."""

    blocks: tuple                   # ModelBlock per device, in vertex order
    faces: torch.Tensor
    left_hand_components: torch.Tensor
    right_hand_components: torch.Tensor
    left_hand_mean: torch.Tensor
    right_hand_mean: torch.Tensor
    extra_joint_vids: torch.Tensor
    lmk_faces_idx: torch.Tensor
    lmk_bary_coords: torch.Tensor
    dyn_lmk_faces_idx: torch.Tensor
    dyn_lmk_bary_coords: torch.Tensor
    parents: tuple
    num_verts: int
    num_joints: int
    neck_kin_chain: tuple


def _shard_row(model: SMPLXModel, devices) -> ShardedModel:
    V, n = model.num_verts, len(devices)
    if V < n:
        raise ValueError(f"shard_model: {V} vertices over {n} devices")
    blocks, lo = [], 0
    for i, dev in enumerate(devices):
        size = V // n + (i < V % n)
        cut = {}
        for name, dim in _VERTEX_DIM.items():
            t = getattr(model, name)
            scale = 3 if name == "posedirs" else 1
            # a copy of its own: each block's tensors start aligned
            cut[name] = t.narrow(dim, lo * scale, size * scale) \
                .to(dev, copy=True).contiguous()
        blocks.append(ModelBlock(**cut, lbs_plan=lbs_plan(cut["lbs_weights"])))
        lo += size
    shared = {f.name: to_device(getattr(model, f.name), devices[0])
              for f in dataclasses.fields(SMPLXModel)
              if f.name not in _VERTEX_DIM and f.name != "lbs_plan"}
    return ShardedModel(blocks=tuple(blocks), **shared)


def shard_model(model: SMPLXModel, mesh: Mesh) -> list:
    """Per data row, the model with its vertices split into n_model
    contiguous blocks, one per device of the row (the split of JAX's specs:
    dim 0 of v_template, shapedirs, exprdirs and lbs_weights, the V * 3
    output dim of posedirs, the V input dim of J_regressor), each with the
    column plan of its own weights; the index tables replicated on the
    row's lead device."""
    return [_shard_row(model, row) for row in mesh.devices]


# ---------------------------------------------------------------- workers


def _launch_counts() -> dict:
    return {"lbs": lbs_apply.launches, "gather": gather_rows.launches,
            "scatter": scatter_add_rows.launches,
            "scatter_join": scatter_add_rows.join_launches,
            "level2": collision.level2_hits.launches,
            "lbs_plan_builds": lbs_plan.builds}


def _worker(conn, devices: list, shard_model_axis: bool) -> None:
    """One data row: receive the pickled inputs, move them to the row's
    devices, fit, send back ("ok", FitResult on the CPU, stats) or
    ("error", traceback, None)."""
    entered_at = time.time()
    try:
        shared = pickle.loads(conn.recv_bytes())
        own = pickle.loads(conn.recv_bytes())

        devs = [torch.device(d) for d in devices]
        lead = devs[0]
        if lead.type == "cuda":
            torch.cuda.set_device(lead)
            gather._load()
            lbs._load()
            collision._load_k4()
        else:
            torch.set_num_threads(1)
        kwargs = {k: to_device(pickle.loads(v), lead)
                  for k, v in shared["kwargs"].items()}
        args = {k: pickle.loads(v) for k, v in shared.items() if k != "kwargs"}
        model = args.pop("model")
        model = (_shard_row(model, devs) if shard_model_axis
                 else to_device(model, lead))
        args = {k: to_device(v, lead) for k, v in args.items()}
        block = to_device(own, lead)
        if lead.type == "cuda":
            torch.cuda.synchronize(lead)
        before = _launch_counts()
        fit_start = time.time()
        res = fit_batch(model, args["settings"], args["options"],
                        args["stage_weights"], block["frames"], block["x0"],
                        args["decode_body"], args["joint_map"], device=lead,
                        **kwargs)
        if lead.type == "cuda":
            torch.cuda.synchronize(lead)
        fit_end = time.time()
        after = _launch_counts()
        stats = {"devices": devices, "entered_at": entered_at,
                 "fit_start": fit_start, "fit_end": fit_end,
                 "launches": {k: after[k] - before[k] for k in after}}
        msg = ("ok", to_device(res, "cpu"), stats)
    except Exception:
        msg = ("error", traceback.format_exc(), None)
    try:
        conn.send_bytes(pickle.dumps(msg))
    finally:
        conn.close()


def _pickled(name: str, value) -> bytes:
    try:
        return pickle.dumps(value)
    except (pickle.PicklingError, TypeError, AttributeError) as e:
        raise TypeError(
            f"fit_batch_sharded: {name} ({value!r}) cannot be sent to a "
            f"worker process ({type(e).__name__}: {e}); pass a module-level "
            "function or a bound method of a picklable object, not a lambda "
            "or a local function") from e


def _join(results: list, device):
    def cat(name, dim):
        return torch.cat([getattr(r, name) for r in results], dim).to(device)

    return FitResult(
        x=cat("x", 0), loss=cat("loss", 0), camera_loss=cat("camera_loss", 0),
        flipped=cat("flipped", 0), stage_losses=cat("stage_losses", 1),
        stage_evals=cat("stage_evals", 1),
        camera_evals=cat("camera_evals", 0),
        host_reads=sum(r.host_reads for r in results),
        stage_x=None if results[0].stage_x is None else cat("stage_x", 1),
    )


def _collect(procs: list, conns: list, mesh: Mesh) -> list:
    """Each worker's message, in row order; the first failure raises."""
    out = [None] * len(procs)
    pending = set(range(len(procs)))
    while pending:
        ready = set(wait([conns[r] for r in pending]
                         + [procs[r].sentinel for r in pending]))
        for r in sorted(pending):
            if conns[r] not in ready and procs[r].sentinel not in ready:
                continue
            where = f"the worker of data row {r} on " \
                    f"{[str(d) for d in mesh.devices[r]]}"
            try:
                msg = pickle.loads(conns[r].recv_bytes())
            except EOFError:
                procs[r].join()
                raise RuntimeError(f"fit_batch_sharded: {where} exited with "
                                   f"code {procs[r].exitcode} before sending "
                                   "its result") from None
            if msg[0] != "ok":
                raise RuntimeError(f"fit_batch_sharded: {where} failed:\n"
                                   f"{msg[1]}")
            out[r] = msg
            pending.discard(r)
    return out


def fit_batch_sharded(
    mesh: Mesh,
    model: SMPLXModel,
    settings,
    options,
    stage_weights,
    frames,
    x0,
    decode_body,
    joint_map,
    shard_model_axis: bool = False,
    **kwargs,
):
    """Fit `frames` with one worker process per data row of `mesh`.

    Each worker gets its contiguous block of frames and x0, the model and
    the kwargs of `fit_batch` (gmm, edge_idxs, joints_model,
    coll_stage_mask, the hand GMMs, collision_fn) as CPU tensors, moves
    them to its row's lead device (building its K1 plans there), splits the
    model's vertices over the row's devices when `shard_model_axis` is set
    (the joints model stays whole on the lead device), runs `fit_batch`
    and sends its FitResult back.  The results are joined in frame order
    on the mesh's lead device (`host_reads` summed over the rows).
    Every argument must survive pickling into a spawned process: a lambda
    raises TypeError here, and a worker's failure raises RuntimeError with
    its traceback; nothing is fitted in the caller's process.

    `fit_batch_sharded.last_run` holds the run's timings on the host's
    wall clock: per row the seconds from spawn to the fit's start
    (`startup_s`: interpreter, imports, CUDA context, kernel libraries,
    inputs moved, plans built) and of the fit (`fit_s`), its kernel
    launches, and over all rows `startup_s` (spawn to the last fit's
    start), `fit_window_s` (first fit's start to last fit's end) and
    `wall_s`."""
    if "device" in kwargs:
        raise ValueError("fit_batch_sharded: the mesh places the fit; pass "
                         "no device")
    if isinstance(model, ShardedModel):
        raise TypeError("fit_batch_sharded takes the unsharded model; set "
                        "shard_model_axis to split its vertices")
    cpus = ["cpu"] * mesh.shape["data"]
    shared = {name: _pickled(name, to_device(value, "cpu")) for name, value in
              (("model", model), ("settings", settings), ("options", options),
               ("stage_weights", stage_weights),
               ("decode_body", decode_body), ("joint_map", joint_map))}
    shared["kwargs"] = {name: _pickled(name, to_device(value, "cpu"))
                        for name, value in kwargs.items()}
    shared = pickle.dumps(shared)
    own = [pickle.dumps({"frames": f, "x0": x})
           for f, x in zip(_split(frames, cpus), _split(x0, cpus))]

    # Every worker starts before any input is sent: a send blocks until its
    # worker, done with its imports, reads it.
    ctx = torch.multiprocessing.get_context("spawn")
    procs, conns, spawned_at = [], [], []
    t0 = time.time()
    try:
        for row in mesh.devices:
            conn, child = ctx.Pipe()
            proc = ctx.Process(target=_worker, daemon=True,
                               args=(child, [str(d) for d in row],
                                     shard_model_axis))
            spawned_at.append(time.time())
            proc.start()
            child.close()
            procs.append(proc)
            conns.append(conn)
        for conn, data in zip(conns, own):
            conn.send_bytes(shared)
            conn.send_bytes(data)
        msgs = _collect(procs, conns, mesh)
        for proc in procs:
            proc.join()
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()
        for conn in conns:
            conn.close()
    wall = time.time() - t0
    rows = [{"devices": s["devices"],
             "startup_s": s["fit_start"] - spawned_at[r],
             "fit_s": s["fit_end"] - s["fit_start"], "launches": s["launches"]}
            for r, (_, _, s) in enumerate(msgs)]
    stats = [m[2] for m in msgs]
    fit_batch_sharded.last_run = {
        "rows": rows, "wall_s": wall,
        "startup_s": max(s["fit_start"] for s in stats) - t0,
        "fit_window_s": (max(s["fit_end"] for s in stats)
                         - min(s["fit_start"] for s in stats)),
    }
    return _join([m[1] for m in msgs], mesh.lead)


fit_batch_sharded.last_run = None
