from controllora_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    make_serving_mesh,
    replicate,
    shard_batch,
)
