"""Observability of the port: the span/event/counter tracer (`tracer`),
the static per-bucket communication accounting (`counters`), the α-β cost
model the plan tuner prunes with (`costmodel`) and the interconnect fit
and leg-time prediction (`overlap`) — the ported part of the JAX package's
``observability/``."""
