"""Observability of the port: the span/event/counter tracer (`tracer`),
the static per-bucket communication accounting (`counters`), the α-β cost
model the plan tuner prunes with (`costmodel`), the interconnect fit and
leg-time prediction (`overlap`), and the run-health layer the guard reads
— the flight recorder (`flight`), the anomaly detectors (`anomaly`), the
cluster digest aggregation (`aggregate`) and the env redaction of the
forensic dumps (`redaction`) — the ported part of the JAX package's
``observability/``."""
