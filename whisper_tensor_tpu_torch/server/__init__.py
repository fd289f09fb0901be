"""Serving front end of the port (the reference HTTP API on the port)."""
