"""Modules of the port: layers, encoders and retrieval metrics."""
