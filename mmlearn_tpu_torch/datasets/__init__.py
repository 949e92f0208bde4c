"""Host-side data abstractions the port needs (the modality registry)."""
