"""Shape sets (the counterpart of ``repro.configs.base``).

Only the recsys family's shapes are carried over, verbatim: the ported
two-tower model is the one that serves them.  ``repro``'s architecture
registry and its LM and GNN shape sets come with the first ported code
that reads them.
"""
RECSYS_SHAPES = {
    "train_batch": dict(kind="train", batch=65536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}
