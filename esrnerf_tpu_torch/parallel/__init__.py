from esrnerf_tpu_torch.parallel.mesh import (  # noqa: F401
    ParamLayout,
    ShardHelpers,
    World,
    check_parallel_cfg,
    current_world,
    fsdp_shards,
    init_distributed,
    pad_to_multiple,
    parallel_layout,
    shard_rows,
    sharded_train_step,
)
