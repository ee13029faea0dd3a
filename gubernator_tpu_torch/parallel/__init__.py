"""Sharded bucket state on one device: key → shard routing on the host,
every shard's state as one [n_shards, shard_capacity] layout, per-shard
steps in one launch (parallel/sharded_engine.py).

Port of `gubernator_tpu/parallel` without the mesh: the reference's
single-program form, which runs every shard of its mesh as one program
on one device.  The shard_map form, one shard a device with a psum
merge, needs one card a shard.
"""

from gubernator_tpu_torch.parallel.sharded_engine import ShardedDecisionEngine

__all__ = ["ShardedDecisionEngine"]
