"""Lint-rule registry — same shape as the ``FedMethod`` registry in
``core.methods``: rules register by code, consumers ask for them by
code, and adding a rule is one ``register(...)`` call.
"""
from __future__ import annotations

from .base import Finding, ModuleInfo, ProjectContext, Rule
from .dead_mask import DeadMask

_REGISTRY: dict[str, Rule] = {}


def register(rule: Rule, *, overwrite: bool = False) -> Rule:
    if rule.code in _REGISTRY and not overwrite:
        raise ValueError(f"lint rule {rule.code!r} already registered")
    _REGISTRY[rule.code] = rule
    return rule


def get_rule(code: str) -> Rule:
    try:
        return _REGISTRY[code]
    except KeyError:
        raise ValueError(
            f"unknown lint rule {code!r}; available: "
            f"{', '.join(available_rules())}") from None


def available_rules() -> list[str]:
    return sorted(_REGISTRY)


register(DeadMask())

__all__ = [
    "Finding", "ModuleInfo", "ProjectContext", "Rule",
    "register", "get_rule", "available_rules", "DeadMask",
]
