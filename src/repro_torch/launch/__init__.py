"""Entry points: serving (greedy generation, per-tenant merge) and the
production round engine (``train``: one client per ``torch.distributed``
rank, groups from ``mesh``)."""
