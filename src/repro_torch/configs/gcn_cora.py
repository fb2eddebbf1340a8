"""gcn-cora [gnn]: n_layers=2 d_hidden=16 aggregator=mean norm=sym
[arXiv:1609.02907; paper]."""
from ..models.gnn.gcn import GCNConfig
from . import base

FULL = GCNConfig(
    name="gcn-cora", n_layers=2, d_hidden=16, d_in=1433, n_classes=7,
    aggregator="mean", norm="sym",
)
SMOKE = GCNConfig(
    name="gcn-cora-smoke", n_layers=2, d_hidden=8, d_in=32, n_classes=4
)

base.register(
    base.ArchEntry(name="gcn-cora", family="gnn", full=FULL, smoke=SMOKE, model="gcn")
)
