"""Non-IID client partitioning (a copy of ``repro/data/partition.py``).

Heterogeneity is induced the way the paper does it (clients specialize in
different downstream task types): a Dirichlet(alpha) draw over task types
per client.  alpha → 0 gives one-task clients (the paper's setting: each
client = one downstream task); alpha → inf gives IID clients.
"""
from __future__ import annotations

import numpy as np


def dirichlet_task_partition(n_clients: int, n_tasks: int, alpha: float,
                             seed: int = 0) -> np.ndarray:
    """Returns (n_clients, n_tasks) row-stochastic mixture matrix."""
    rng = np.random.default_rng(seed)
    if alpha <= 0:  # degenerate: one task per client, round-robin
        probs = np.zeros((n_clients, n_tasks))
        for c in range(n_clients):
            probs[c, c % n_tasks] = 1.0
        return probs
    return rng.dirichlet([alpha] * n_tasks, size=n_clients)


def specialist_partition(n_clients: int, n_tasks: int) -> np.ndarray:
    """Paper setting: client i trains task (i mod n_tasks) exclusively."""
    return dirichlet_task_partition(n_clients, n_tasks, alpha=0.0)
