"""Utilities of the port: the α-β cost model (`perf_model`), the step and
collective profilers (`profiling`), the Chrome-trace writer
(`chrome_trace`) and the JSONL metrics logger (`metrics`)."""
