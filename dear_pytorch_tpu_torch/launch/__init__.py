"""Launchers of the port (the elastic supervisor)."""
