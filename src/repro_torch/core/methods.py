"""Federated method registry (port of ``repro/core/methods.py``).

A federated PEFT method is a ``FedMethod``: how to build its adapter
overlay, which leaves train in each pipeline stage, how client adapters
aggregate, which loss extras apply and which leaves stay client-local
when the aggregate is rebroadcast.  ``fed/simulate.py`` and
``core/fedlora.py`` consume only this interface.

Ported entries:

  fedlora_opt   the paper's pipeline: decomposed adapters, Eqs. 5-8
                aggregation, stage masks, dB_mag kept client-local
  lora          raw LoRA + FedAvg (FedIT-style)

The reference's other twelve methods are ROADMAP A8: ``get_method``
raises NotImplementedError naming it.  So are the reference's fields for
what only they or mixed-rank fleets use (``prox``, ``het_ranks``,
``rank_aware``, ``server_zero_rx``): ``FedMethod`` has none of them.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Optional

from repro_torch.core import aggregation as agg
from repro_torch.core import peft

Params = Any
MaskFn = Callable[[Params], Params]

# registered in the reference, not ported yet (ROADMAP A8)
UNPORTED = ("ffa_lora", "fedprox", "prompt", "adapter", "fedalt",
            "lora_trimmed", "lora_fedbuff", "lora_fedavg_q8",
            "lora_fedavg_topk", "lora_zeropad", "lora_replication",
            "lora_exact")


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
    # loss extra: Eq. 11 ½λ‖·‖²_F mask (stage 3)
    personal_reg: Optional[MaskFn] = None
    # True → the paper's staged pipeline (aggregate → global stage on the
    # server mixture → final per-client stage)
    pipeline: bool = False
    # the production round engine's collective form (ROADMAP A11); None →
    # a mean, billed at the psum rate
    collective: Optional[Any] = None
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
        if name in UNPORTED:
            raise NotImplementedError(
                f"federated method {name!r} is not ported yet "
                f"(ROADMAP A8)") from None
        raise ValueError(
            f"unknown federated method {name!r}; available: "
            f"{', '.join(available_methods())}") from None


def available_methods() -> list[str]:
    return sorted(_REGISTRY)


register(FedMethod(
    name="fedlora_opt",
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
    make_adapter=partial(peft.add_lora, decomposed=False),
    train_mask=peft.mask_all,
    description="raw LoRA + FedAvg (FedIT-style baseline)",
))
