"""Entry points: serving (greedy generation, per-tenant merge), the
production round engine (``train``: one client per ``torch.distributed``
rank, or a data × model grid of ranks, from ``mesh``; the grid's layout
in ``specs``) and the one-card dry run (``dryrun``, its records rendered
by ``report``)."""
