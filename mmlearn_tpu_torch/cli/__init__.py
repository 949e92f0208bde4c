"""The port's experiment CLI (``mmlearn_torch_run``)."""
