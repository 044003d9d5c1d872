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
