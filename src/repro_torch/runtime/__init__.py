"""repro_torch.runtime — what the port needs of ``repro``'s runtime layer."""
