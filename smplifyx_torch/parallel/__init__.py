from smplifyx_torch.parallel.mesh import (
    Mesh,
    ShardedModel,
    fit_batch_sharded,
    make_mesh,
    replicate,
    shard_frames,
    shard_model,
    to_device,
)

_MULTIHOST = ("dryrun_multihost", "fit_batch_multihost", "initialize",
              "launch_ranks", "process_allgather", "process_count",
              "process_index", "process_rows", "shutdown")


def __getattr__(name):
    # multihost's names load on first use, so that `python -m
    # smplifyx_torch.parallel.multihost` runs the module once, as __main__.
    if name in _MULTIHOST:
        from smplifyx_torch.parallel import multihost

        return getattr(multihost, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
