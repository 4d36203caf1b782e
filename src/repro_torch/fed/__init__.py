"""The federated engine (``FedSim``: stage-1 rounds, aggregation, stages 2
and 3, faulted cohort rounds) and cross-device cohorts over a host-side
client bank (``cohort``)."""
from repro_torch.fed.simulate import FedSim, FedHyper  # noqa: F401
from repro_torch.fed.cohort import (ClientBank, CohortSampler,  # noqa: F401
                                    CohortSim, FaultPlan)
