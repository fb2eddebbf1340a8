"""repro_torch.train — the train loop and the optimizers."""
