"""schnet [gnn]: n_interactions=3 d_hidden=64 rbf=300 cutoff=10
[arXiv:1706.08566; paper]."""
from ..models.gnn.schnet import SchNetConfig
from . import base

FULL = SchNetConfig(name="schnet", n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)
SMOKE = SchNetConfig(name="schnet-smoke", n_interactions=2, d_hidden=16, n_rbf=16, cutoff=5.0)

base.register(
    base.ArchEntry(name="schnet", family="gnn", full=FULL, smoke=SMOKE, model="schnet")
)
