"""Fitting across hosts: one process per host over `torch.distributed`.

Counterpart of the JAX package's multi-host dry run
(`__graft_entry__.py::dryrun_multihost`, one JAX process per host over
`jax.distributed`).  N processes (ranks) rendezvous at a coordinator
address with an explicit world size and rank (`initialize`); every rank
builds the same global problem from a seed, keeps only its contiguous
block of frames (`process_rows`), fits it on its own devices
(`fit_batch_multihost`: `fit_batch` on one device, `fit_batch_sharded`
over several) and gathers every rank's result, so that each holds the
global result in frame order (`process_allgather`).

The process group is gloo's, over TCP.  Only finished results cross
processes (for 64 lanes: the 122-dim x, the losses and the per-stage
arrays, tens of KB), and they are read on the host anyway, as JAX's
`process_allgather` returns numpy; gloo moves them through host memory.
NCCL would refuse two ranks on one card, which is how one card stands in
for two hosts here, as JAX's localhost coordinator stands in for the
network between hosts.  There is no backend option.

    python -m smplifyx_torch.parallel.multihost N L [--platform cpu]

starts N ranks on this host (L devices each, frames 2 per device) on
127.0.0.1 and checks that every rank gathered the same bits.  One rank
per real host runs

    python -m smplifyx_torch.parallel.multihost --coordinator HOST:PORT \\
        --num-processes N --process-id I [--devices cuda:0,cuda:1]

Without `--platform cpu` the ranks run on the card and raise without one.
Every wait has a limit: the rendezvous `initialization_timeout`, the
collectives the process group's timeout, the launcher `timeout_s`.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

from smplifyx_torch.fitting.pipeline import FitResult, fit_batch
from smplifyx_torch.parallel.mesh import (
    _launch_counts,
    fit_batch_sharded,
    make_mesh,
)
from smplifyx_torch.utils.device import resolve_device
from smplifyx_torch.utils.tensors import TensorFields

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------- identity


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               initialization_timeout: float = 300) -> None:
    """Join the process group of `num_processes` ranks at
    `coordinator_address` ("host:port", where rank 0 listens) as rank
    `process_id`; raises when the others have not all arrived within
    `initialization_timeout` seconds, which also bounds every later
    collective."""
    if not 0 <= process_id < num_processes:
        raise ValueError(f"initialize: process_id {process_id} is not a rank "
                         f"of {num_processes} processes")
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=initialization_timeout))


def process_index() -> int:
    """This process's rank; 0 outside a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks; 1 outside a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- rows


def process_rows(batch: int) -> tuple[int, int]:
    """(lo, hi): this process's contiguous block of a global batch, the
    blocks equal and in rank order."""
    n = process_count()
    if batch % n:
        raise ValueError(f"process_rows: {batch} frames do not divide over "
                         f"{n} processes")
    b = batch // n
    r = process_index()
    return r * b, (r + 1) * b


def process_allgather(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's `tensor` joined on dim 0 in rank order, on the input's
    device (JAX's `process_allgather(..., tiled=True)`).  Every rank must
    pass the same shape and dtype; otherwise every rank raises."""
    meta = (tuple(tensor.shape), str(tensor.dtype))
    metas = [None] * process_count()
    dist.all_gather_object(metas, meta)
    if any(m != meta for m in metas):
        raise ValueError("process_allgather: the ranks' tensors differ in "
                         "shape or dtype: " + ", ".join(
                             f"rank {r} {m[0]} {m[1]}"
                             for r, m in enumerate(metas)))
    local = tensor.detach().cpu().contiguous()
    parts = [torch.empty_like(local) for _ in metas]
    dist.all_gather(parts, local)
    return torch.cat(parts, 0).to(tensor.device)


def _allgather_result(res: FitResult) -> FitResult:
    def on(t, dim):
        return None if t is None else \
            process_allgather(t.movedim(dim, 0)).movedim(0, dim)

    reads = process_allgather(torch.tensor([res.host_reads]))
    return FitResult(
        x=on(res.x, 0), loss=on(res.loss, 0),
        camera_loss=on(res.camera_loss, 0), flipped=on(res.flipped, 0),
        stage_losses=on(res.stage_losses, 1),
        stage_evals=on(res.stage_evals, 1),
        camera_evals=on(res.camera_evals, 0),
        host_reads=int(reads.sum()), stage_x=on(res.stage_x, 1))


# ---------------------------------------------------------------- the fit


def _local_devices(devices=None) -> list:
    """The devices a rank fits on: `devices`, or every CUDA card of this
    host (raising without one)."""
    if devices is None:
        resolve_device("cuda")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if not devices:
        raise ValueError("a rank needs at least one device")
    return [resolve_device(d) for d in devices]


def fit_batch_multihost(model, settings, options, stage_weights, frames, x0,
                        decode_body, joint_map, devices=None,
                        **kwargs) -> FitResult:
    """Fit this process's rows (`frames`, `x0`) and gather every rank's
    result, in frame order, into each rank.

    On one device it runs `fit_batch` there (the inputs must lie on it);
    over several, `fit_batch_sharded` on a mesh of them, one worker per
    device.  `devices` defaults to every CUDA card of this host; the CPU
    runs only when the caller passes CPU devices.  `x`, `loss`,
    `camera_loss`, `flipped` and `camera_evals` are joined on dim 0,
    `stage_losses`, `stage_evals` and `stage_x` on dim 1, and `host_reads`
    is summed.

    `fit_batch_multihost.last_run` holds the host-clock seconds of the
    local fit (`fit_s`, from `fit_start` to `fit_end` on `time.time()`),
    of the wait at a barrier for the other ranks' fits (`wait_s`) and of
    the gather after it (`gather_s`), and the kernel launches of the
    local fit (summed over the workers under a mesh)."""
    if "device" in kwargs:
        raise ValueError("fit_batch_multihost: `devices` places the fit; "
                         "pass no device")
    devs = _local_devices(devices)
    args = (model, settings, options, stage_weights, frames, x0, decode_body,
            joint_map)
    if devs[0].type == "cuda":
        torch.cuda.synchronize(devs[0])
    before = _launch_counts()
    fit_start = time.time()
    if len(devs) == 1:
        res = fit_batch(*args, device=devs[0], **kwargs)
        if devs[0].type == "cuda":
            torch.cuda.synchronize(devs[0])
        launches = {k: v - before[k] for k, v in _launch_counts().items()}
    else:
        res = fit_batch_sharded(make_mesh(devices=devs), *args, **kwargs)
        rows = fit_batch_sharded.last_run["rows"]
        launches = {k: sum(r["launches"][k] for r in rows) for k in before}
    fit_end = time.time()
    dist.barrier()          # the wait for the slowest rank, apart
    gather_start = time.time()
    gathered = _allgather_result(res)
    fit_batch_multihost.last_run = {
        "devices": [str(d) for d in devs], "fit_start": fit_start,
        "fit_end": fit_end, "fit_s": fit_end - fit_start,
        "wait_s": gather_start - fit_end,
        "gather_s": time.time() - gather_start, "launches": launches}
    return gathered


fit_batch_multihost.last_run = None


def digest(*trees) -> str:
    """A hex SHA-256 of the dtypes, shapes and bytes of every tensor in
    `trees` (tensors, dataclasses of them, lists, tuples, dicts), in
    order: equal digests mean equal bits."""
    h = hashlib.sha256()

    def walk(v):
        if isinstance(v, torch.Tensor):
            t = v.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        elif isinstance(v, TensorFields):
            for name in v.__dataclass_fields__:
                walk(getattr(v, name))
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    for tree in trees:
        walk(tree)
    return h.hexdigest()


# ---------------------------------------------------------------- launcher


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_ranks(argvs: list, timeout_s: float = 600, cwd: str = REPO) -> list:
    """Start one fresh interpreter per entry of `argvs` on this host, rank
    i as `python *argvs[i] --coordinator 127.0.0.1:PORT --num-processes N
    --process-id i`, and return each one's output (stdout and stderr), in
    rank order, once all have exited with 0.

    The first rank that exits with another code makes this kill the
    others and raise RuntimeError with that rank's output; when
    `timeout_s` passes first, every rank is killed and RuntimeError names
    those still running, with their output.  Each rank runs in a session
    of its own and is killed with the processes it started (a mesh's
    workers), so none outlives the call.
    `launch_ranks.last_run` holds the coordinator address, `started_at`
    (`time.time()` before the first start) and the ranks' pids and exit
    codes."""
    n = len(argvs)
    addr = f"127.0.0.1:{_free_port()}"
    logs, procs = [], []
    started_at = time.time()

    def output(i):
        logs[i].seek(0)
        return logs[i].read().decode(errors="replace")

    try:
        for i, argv in enumerate(argvs):
            logs.append(tempfile.TemporaryFile())
            procs.append(subprocess.Popen(
                [sys.executable, *argv, "--coordinator", addr,
                 "--num-processes", str(n), "--process-id", str(i)],
                cwd=cwd, stdout=logs[-1], stderr=subprocess.STDOUT,
                start_new_session=True))
        deadline = started_at + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [i for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                i = failed[0]
                raise RuntimeError(f"rank {i} of {n} exited with code "
                                   f"{codes[i]}:\n{output(i)}")
            if None not in codes:
                return [output(i) for i in range(n)]
            if time.time() > deadline:
                running = [i for i, c in enumerate(codes) if c is None]
                raise RuntimeError(
                    f"ranks {running} of {n} still running after "
                    f"{timeout_s} s; killed. Their output:\n" + "\n".join(
                        f"--- rank {i}:\n{output(i)}" for i in running))
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:      # it ended meanwhile
                    pass
            p.wait()
        for f in logs:
            f.close()
        launch_ranks.last_run = {
            "coordinator": addr, "started_at": started_at,
            "pids": [p.pid for p in procs],
            "returncodes": [p.returncode for p in procs]}


launch_ranks.last_run = None


def dryrun_multihost(n_processes: int = 2, n_local_devices: int = 1,
                     device="cuda", timeout_s: float = 600) -> dict:
    """N ranks on this host, each on `n_local_devices` devices, fit
    `problem.multihost_problem` (2 frames per device, V=64) from their own
    rows and gather the global result; every rank must print the same
    GLOBAL_LOSS line (the losses exactly, and a digest of the gathered
    loss and x).  Ranks on the card take cuda:(i * L + k) modulo the
    cards present, so one card can carry every rank.

    Returns {"loss": [float per frame], "digest": str, "outputs": [each
    rank's output]}; raises RuntimeError when a rank fails or the lines
    differ."""
    dev = resolve_device(device)
    L = n_local_devices
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        devs = [[f"cuda:{(i * L + k) % count}" for k in range(L)]
                for i in range(n_processes)]
    else:
        devs = [["cpu"] * L for _ in range(n_processes)]
    platform = ["--platform", "cpu"] if dev.type == "cpu" else []
    outs = launch_ranks([["-m", "smplifyx_torch.parallel.multihost",
                          "--devices", ",".join(d), *platform] for d in devs],
                        timeout_s)
    lines = [[ln for ln in out.splitlines() if ln.startswith("GLOBAL_LOSS ")]
             for out in outs]
    if any(len(ls) != 1 for ls in lines) or len({ls[0] for ls in lines}) != 1:
        raise RuntimeError("dryrun_multihost: the ranks' GLOBAL_LOSS lines "
                           "differ:\n" + "\n".join(outs))
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith(("SHARD ", "GLOBAL_LOSS ")):
                print(ln)
    print(f"dryrun_multihost OK: {n_processes} processes x {L} devices on "
          f"{dev.type}, the ranks' global results agree to the bit")
    fields = lines[0][0].split()
    return {"loss": [float(v) for v in fields[2:]],
            "digest": fields[1].removeprefix("digest="), "outputs": outs}


def _rank(args) -> None:
    from smplifyx_torch.problem import multihost_problem

    on_cpu = args.platform == "cpu"
    if on_cpu:
        torch.set_num_threads(1)
    initialize(args.coordinator, args.num_processes, args.process_id,
               args.initialization_timeout)
    try:
        devs = _local_devices(args.devices.split(",") if args.devices
                             else ["cpu"] if on_cpu else None)
        if devs[0].type == "cuda":
            torch.cuda.set_device(devs[0])
        B = 2 * process_count() * len(devs)
        problem = multihost_problem(B, device=devs[0])
        lo, hi = process_rows(B)
        frames = problem.pop("frames").map(lambda a: a[lo:hi])
        x0 = problem.pop("x0")[lo:hi]
        print(f"SHARD process={process_index()} local_rows={hi - lo} of B={B} "
              f"devices={','.join(str(d) for d in devs)}", flush=True)
        res = fit_batch_multihost(frames=frames, x0=x0, devices=devs,
                                  **problem)
        loss = res.loss.cpu()
        if tuple(loss.shape) != (B,) or not bool(torch.isfinite(loss).all()):
            raise RuntimeError(f"the gathered loss is {loss}")
        print(f"GLOBAL_LOSS digest={digest(res.loss, res.x)} "
              + " ".join(repr(float(v)) for v in loss), flush=True)
    finally:
        shutdown()


def rank_parser() -> argparse.ArgumentParser:
    """A parent parser of the flags `launch_ranks` appends to a rank's
    command line, and the rendezvous limit."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--coordinator", required=True,
                   help="HOST:PORT where rank 0 listens")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--initialization-timeout", type=float, default=300,
                   help="seconds to wait for every rank to arrive")
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    prog = "python -m smplifyx_torch.parallel.multihost"
    platform = dict(choices=("gpu", "cuda", "cpu"), default="gpu",
                    help="cpu runs the ranks on the CPU; default the card")
    if "--coordinator" in argv:
        p = argparse.ArgumentParser(prog=prog, parents=[rank_parser()],
                                    description="Run one rank.")
        p.add_argument("--platform", **platform)
        p.add_argument("--devices", default=None,
                       help="this rank's devices, comma-separated; default "
                            "every card of the host (the CPU under "
                            "--platform cpu)")
        _rank(p.parse_args(argv))
        return 0
    p = argparse.ArgumentParser(
        prog=prog, description="Start N ranks of L devices each on this "
        "host and check that they gather the same global result.")
    p.add_argument("n_processes", type=int)
    p.add_argument("n_local_devices", type=int, nargs="?", default=1)
    p.add_argument("--platform", **platform)
    p.add_argument("--timeout", type=float, default=600,
                   help="seconds to wait for every rank")
    args = p.parse_args(argv)
    dryrun_multihost(args.n_processes, args.n_local_devices,
                     "cpu" if args.platform == "cpu" else "cuda", args.timeout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
