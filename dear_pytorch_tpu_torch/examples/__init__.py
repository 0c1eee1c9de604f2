"""User-facing examples of the port."""
