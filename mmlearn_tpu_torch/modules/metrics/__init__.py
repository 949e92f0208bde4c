"""Retrieval metrics of the port (the exact top-k search so far)."""
