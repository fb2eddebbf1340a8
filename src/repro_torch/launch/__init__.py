"""repro_torch.launch — the port's command-line entry points (``serve``)."""
