"""Federated method registry (port of ``repro/core/methods.py``).

A federated PEFT method is a ``FedMethod``: how to build its adapter
overlay, which leaves train in each pipeline stage, how client adapters
aggregate, which loss extras apply (the FedProx term, the paper's Eq. 11
regularizer) and which leaves stay client-local when the aggregate is
rebroadcast.  ``fed/simulate.py`` and ``core/fedlora.py`` consume only
this interface.

Registered (every method of the reference):

  fedlora_opt       the paper's pipeline: decomposed adapters, Eqs. 5-8
                    aggregation, stage masks, dB_mag kept client-local
  lora              raw LoRA + FedAvg (FedIT-style)
  ffa_lora          raw LoRA with A frozen (Sun et al.)
  fedprox           raw LoRA + proximal term (Li et al.)
  prompt            prompt tuning (Lester et al.)
  adapter           Houlsby bottleneck adapters
  fedalt            dual shared + individual LoRA pairs (FedALT-style)
  lora_trimmed      raw LoRA + coordinate-wise trimmed mean
  lora_fedbuff      raw LoRA + FedBuff staleness-weighted mean
  lora_fedavg_q8    raw LoRA + FedAvg over a stochastic int8 uplink
  lora_fedavg_topk  raw LoRA + FedAvg over a top-k (5%) uplink

Mixed-rank fleets (adapters allocated at r_max, per-client rank masks):
``het_ranks`` methods accept ``FedHyper.client_ranks``, and three
rank-aware aggregators take the fleet's ranks:

  lora_zeropad      naive zero-pad averaging (degradation baseline)
  lora_replication  coverage-weighted averaging (replication-style)
  lora_exact        exact Σw·AB via stacked factors + truncated SVD
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

from repro_torch.core import aggregation as agg
from repro_torch.core import peft

Params = Any
MaskFn = Callable[[Params], Params]


@dataclasses.dataclass(frozen=True)
class FedMethod:
    """Everything the engine needs to know about one federated method."""
    name: str
    # adapter factory: (base_params, ArchConfig, torch.Generator) -> overlay
    make_adapter: Callable[[Params, Any, Any], Params]
    # stage-1 trainable mask (client local training)
    train_mask: MaskFn
    # stage-2 / stage-3 masks; None → same leaves as stage 1
    global_mask: Optional[MaskFn] = None
    local_mask: Optional[MaskFn] = None
    # aggregation over the leading client axis: (client_adapters) -> tree
    aggregate: Callable[[Params], Params] = agg.fedavg
    # regex over leaf paths kept client-local through every rebroadcast
    keep_local: Optional[str] = None
    # loss extras: the FedProx ½µ‖θ−θ_ref‖² term (stage 1) and the
    # Eq. 11 ½λ‖·‖²_F mask (stage 3)
    prox: bool = False
    personal_reg: Optional[MaskFn] = None
    # True → the paper's staged pipeline (aggregate → global stage on the
    # server mixture → final per-client stage)
    pipeline: bool = False
    # True → the adapter factory accepts rank= and its leaves follow
    # peft.rank_axis, so the engine can run a mixed-rank fleet
    het_ranks: bool = False
    # True → ``aggregate`` accepts ranks=(C,) (the rank-aware family);
    # the engine passes the fleet's ranks
    rank_aware: bool = False
    # the aggregation as a collective over the client group, for the
    # production engine (launch/train.py); None → the one the aggregate
    # maps to (aggregation.collective_form)
    collective: Optional[agg.CollectiveAgg] = None
    # regex over leaf paths the aggregated (server) model zeroes, or None
    server_zero_rx: Optional[str] = None
    description: str = ""

    def stage_global_mask(self, adapters: Params) -> Params:
        return (self.global_mask or self.train_mask)(adapters)

    def stage_local_mask(self, adapters: Params) -> Params:
        return (self.local_mask or self.train_mask)(adapters)

    def stage_mask(self, adapters: Params, stage: str) -> Params:
        """Trainable mask for one pipeline stage: 'local_pretrain' (stage
        1), 'global' (stage 2) or 'local' (stage 3)."""
        if stage == "global":
            return self.stage_global_mask(adapters)
        if stage == "local":
            return self.stage_local_mask(adapters)
        if stage == "local_pretrain":
            return self.train_mask(adapters)
        raise ValueError(f"unknown pipeline stage {stage!r} "
                         "(local_pretrain | global | local)")


_REGISTRY: dict[str, FedMethod] = {}


def register(method: FedMethod, *, overwrite: bool = False) -> FedMethod:
    """Add a method to the registry (returns it, so usable inline)."""
    if method.name in _REGISTRY and not overwrite:
        raise ValueError(f"method {method.name!r} already registered")
    _REGISTRY[method.name] = method
    return method


def get_method(name: str) -> FedMethod:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown federated method {name!r}; available: "
            f"{', '.join(available_methods())}") from None


def available_methods() -> list[str]:
    return sorted(_REGISTRY)


register(FedMethod(
    name="fedlora_opt",
    het_ranks=True,
    make_adapter=partial(peft.add_lora, decomposed=True),
    train_mask=peft.mask_stage_local_pretrain,
    global_mask=peft.mask_stage_global,
    local_mask=peft.mask_stage_local,
    aggregate=agg.decomposed_fedavg,
    keep_local=r"dB_mag$",
    personal_reg=peft.reg_mask_dB,
    pipeline=True,
    description="the paper's global+local optimizer pipeline (Fig. 2)",
))

register(FedMethod(
    name="lora",
    het_ranks=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    description="raw LoRA + FedAvg (FedIT-style baseline)",
))

register(FedMethod(
    name="ffa_lora",
    het_ranks=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_ffa,
    description="LoRA with A frozen (FFA-LoRA, Sun et al.)",
))

register(FedMethod(
    name="fedprox",
    het_ranks=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    prox=True,
    description="LoRA + proximal term to the round reference (FedProx)",
))

register(FedMethod(
    name="prompt",
    make_adapter=peft.add_prompt_tuning,
    train_mask=peft.mask_all,
    description="prompt-tuning (Lester et al.)",
))

register(FedMethod(
    name="adapter",
    make_adapter=peft.add_adapter_tuning,
    train_mask=peft.mask_all,
    description="Houlsby bottleneck adapters",
))

# FedALT's individual pair: kept out of the aggregate, zeroed in the
# server's model and kept per client through every rebroadcast
_FEDALT_LOCAL = r"local_[AB]$"

register(FedMethod(
    name="fedalt",
    het_ranks=True,
    make_adapter=peft.add_dual_lora,
    train_mask=peft.mask_all,
    # the individual pair never reaches the server: zeroed in the
    # aggregate (global / eval model = shared pair only) and restored
    # per client by the keep-local rebroadcast
    aggregate=partial(agg.fedavg_excluding, exclude_rx=_FEDALT_LOCAL),
    keep_local=_FEDALT_LOCAL,
    server_zero_rx=_FEDALT_LOCAL,
    description=("dual adapters: shared rest-of-world LoRA pair is "
                 "aggregated, the individual local_A/local_B pair never "
                 "leaves the client (FedALT-style)"),
))

register(FedMethod(
    name="lora_trimmed",
    het_ranks=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    aggregate=partial(agg.trimmed_fedavg, trim_ratio=0.25),
    collective=agg.gather_trimmed(0.25),
    description=("LoRA + coordinate-wise trimmed-mean aggregation — "
                 "robust to adversarial/outlier clients (cf. Koo et al.)"),
))

register(FedMethod(
    name="lora_fedbuff",
    het_ranks=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    aggregate=agg.StalenessFedAvg(alpha=0.5),
    description=("raw LoRA + FedBuff-style staleness-weighted buffered "
                 "aggregation — each client's update is discounted by "
                 "(1+τ)^(−α) for τ rounds of staleness before the "
                 "weighted mean (async/buffered rounds; Nguyen et al.)"),
))

register(FedMethod(
    name="lora_fedavg_q8",
    het_ranks=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    aggregate=agg.CompressedFedAvg(mode="q8"),
    collective=agg.COMPRESSED_Q8,
    description=("raw LoRA + FedAvg over a stochastic-rounded int8 "
                 "uplink — ~4× less uplink traffic, unbiased rounding "
                 "(COMPRESSED comm class)"),
))

register(FedMethod(
    name="lora_fedavg_topk",
    het_ranks=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    aggregate=agg.CompressedFedAvg(mode="topk", topk_ratio=0.05),
    collective=agg.compressed_topk(0.05),
    description=("raw LoRA + FedAvg over a magnitude top-k sparsified "
                 "uplink (5% density, deterministic; COMPRESSED comm "
                 "class)"),
))

register(FedMethod(
    name="lora_zeropad",
    het_ranks=True,
    rank_aware=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    aggregate=agg.zeropad_fedavg,
    description=("raw LoRA, mixed-rank fleet, naive zero-pad averaging "
                 "(the degradation baseline of Koo et al.)"),
))

register(FedMethod(
    name="lora_replication",
    het_ranks=True,
    rank_aware=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    aggregate=agg.replication_fedavg,
    collective=agg.COVERAGE,
    description=("raw LoRA, mixed-rank fleet, coverage-weighted "
                 "(replication-style) averaging — rank row j averages "
                 "only the clients that own it (cf. Koo et al.)"),
))

register(FedMethod(
    name="lora_exact",
    het_ranks=True,
    rank_aware=True,
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    aggregate=agg.exact_fedavg,
    collective=agg.GATHER_EXACT,
    description=("raw LoRA, mixed-rank fleet, exact Σw·AB aggregation "
                 "via stacked factors + truncated-SVD re-factorization "
                 "(cf. Nguyen et al.)"),
))
