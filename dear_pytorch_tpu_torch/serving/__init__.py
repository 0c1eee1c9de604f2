"""The serving stack: the ring KV cache and the continuous-batching engine."""
