"""Serving: the continuous-batching engine, the pipelined and sharded
offload frontends, and intra-call shard planning."""
