"""repro_torch.models.gnn — GCN, SchNet, GraphCast and MACE."""
