"""Data plane of the port: the tensor wire."""
