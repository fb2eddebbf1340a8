"""repro_torch.io — graph sources."""
