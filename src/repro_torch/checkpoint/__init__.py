"""Checkpoints in the JAX package's msgpack format, and weights carried
across from it (``bridge``)."""
from repro_torch.checkpoint.ckpt import (checkpoint_leaf_paths,  # noqa: F401
                                         has_shard, list_shards,
                                         load_checkpoint_flat,
                                         load_shard_flat, restore_checkpoint,
                                         save_checkpoint, save_shard,
                                         shard_path)
