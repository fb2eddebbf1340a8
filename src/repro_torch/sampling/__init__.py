"""repro_torch.sampling — neighbour sampling for minibatch GNN training."""
