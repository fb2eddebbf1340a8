"""repro_torch.configs — the ported configs and shape sets."""
