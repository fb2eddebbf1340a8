"""mace [gnn]: n_layers=2 d_hidden=128 l_max=2 correlation_order=3 n_rbf=8
equivariance=E(3)-ACE [arXiv:2206.07697; paper]."""
from ..models.gnn.mace import MACEConfig
from . import base

FULL = MACEConfig(
    name="mace", n_layers=2, d_hidden=128, l_max=2, correlation_order=3, n_rbf=8
)
SMOKE = MACEConfig(
    name="mace-smoke", n_layers=2, d_hidden=16, l_max=2, correlation_order=3, n_rbf=4
)

base.register(
    base.ArchEntry(name="mace", family="gnn", full=FULL, smoke=SMOKE, model="mace")
)
