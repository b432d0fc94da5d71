from esrnerf_tpu_torch.parallel.mesh import (  # noqa: F401
    ShardHelpers,
    World,
    check_parallel_cfg,
    current_world,
    init_distributed,
    pad_to_multiple,
    shard_rows,
    sharded_train_step,
)
