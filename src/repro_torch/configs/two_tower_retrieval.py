"""two-tower-retrieval [recsys]: embed_dim=256 tower_mlp=1024-512-256
interaction=dot — sampled-softmax retrieval [RecSys'19 (YouTube); unverified]."""
from ..models.recsys.two_tower import TwoTowerConfig
from . import base

FULL = TwoTowerConfig(
    name="two-tower-retrieval",
    embed_dim=256,
    tower_mlp=(1024, 512, 256),
    n_users=10_000_000,
    n_items=10_000_000,
    n_user_fields=4,
    n_item_fields=2,
    bag_size=16,
)
SMOKE = TwoTowerConfig(
    name="two-tower-smoke",
    embed_dim=16,
    tower_mlp=(32, 16),
    n_users=1000,
    n_items=1000,
    n_user_fields=2,
    n_item_fields=2,
    bag_size=4,
)

base.register(
    base.ArchEntry(
        name="two-tower-retrieval",
        family="recsys",
        full=FULL,
        smoke=SMOKE,
        model="two_tower",
    )
)
