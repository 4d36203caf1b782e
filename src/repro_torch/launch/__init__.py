"""Entry points: serving (greedy generation, per-tenant merge), the
production round engine (``train``: one client per ``torch.distributed``
rank, groups from ``mesh``) and the one-card dry run (``dryrun``, its
records rendered by ``report``)."""
