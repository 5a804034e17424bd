from loner_tpu_torch.parallel.sharding import (
    make_mesh,
    replicate_to_mesh,
    shard_window,
    make_sharded_train_step,
)
