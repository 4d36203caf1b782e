"""Multi-tenant adapter serving engine (S-LoRA / Punica style).

One frozen backbone, many tiny per-tenant adapters, one mixed batch:

  adapter_store  — packs per-tenant LoRA / decomposed-DoRA adapters into
                   stacked pools [n_slots, ...] with LRU register/evict;
                   the tiered store pages a fleet from disk through a
                   host cache into that pool
  batcher        — continuous batcher: admits tenant-tagged requests
                   into free rows of a persistent batch
  engine         — prefill/decode loop threading per-row adapter_idx
                   through the model and the BGMV kernels
"""
from repro_torch.serve.adapter_store import (AdapterStore,  # noqa: F401
                                             TieredAdapterStore)
from repro_torch.serve.batcher import ContinuousBatcher, Request  # noqa: F401
from repro_torch.serve.engine import ServeEngine  # noqa: F401
