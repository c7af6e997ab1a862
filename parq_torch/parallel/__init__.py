from .multihost import host_shard_indices

__all__ = ["host_shard_indices"]
