"""The federated engine (``FedSim``: stage-1 rounds, aggregation, stages 2
and 3)."""
