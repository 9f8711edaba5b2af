"""Data parallelism over processes (``dist``): the counterpart of
``rel_pose_tpu/parallel``."""

from .dist import (all_reduce_mean, all_reduce_sum, allgather_ragged,
                   backend, build_kernels_once, check_equal_shards,
                   check_same_state, init_distributed, is_main, joined,
                   launched, rank, shard_sizes, shutdown, spawn,
                   state_digest, unwrap, world_size, wrap_ddp)

__all__ = ["all_reduce_mean", "all_reduce_sum", "allgather_ragged",
           "backend", "build_kernels_once", "check_equal_shards",
           "check_same_state", "init_distributed", "is_main", "joined",
           "launched", "rank", "shard_sizes", "shutdown", "spawn",
           "state_digest", "unwrap", "world_size", "wrap_ddp"]
