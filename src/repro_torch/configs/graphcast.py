"""graphcast [gnn]: n_layers=16 d_hidden=512 mesh_refinement=6 aggregator=sum
n_vars=227 — encoder-processor-decoder mesh GNN [arXiv:2212.12794; unverified]."""
from ..models.gnn.graphcast import GraphCastConfig
from . import base

FULL = GraphCastConfig(
    name="graphcast", n_layers=16, d_hidden=512, n_vars=227, mesh_refinement=6,
    aggregator="sum",
)
SMOKE = GraphCastConfig(
    name="graphcast-smoke", n_layers=2, d_hidden=32, n_vars=11, mesh_refinement=1
)

base.register(
    base.ArchEntry(
        name="graphcast", family="gnn", full=FULL, smoke=SMOKE, model="graphcast"
    )
)
