"""Model interfaces of the port."""
