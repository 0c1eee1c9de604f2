"""Data-parallel schedules: the DeAR schedule (`parallel.dear`)."""
