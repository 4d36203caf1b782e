"""repro_torch.lint — the port's repo-aware analyzer and runtime
sanitizer (port of ``repro/lint``).

Static half: rule R5, dead-mask detection, behind a rule registry of the
reference's shape, run by ``python -m repro_torch.lint <paths>`` with
per-line suppressions and a baseline (``runner.py``).  R5 evaluates
every registered ``FedMethod``'s masks and regexes on the port's own
adapter trees, built on meta tensors.  Runtime half:
``repro_torch.lint.sanitize`` (``nan_guard``, ``guard``) for tests and
debugging sessions.

Left out on purpose: the reference's R1–R4 (host sync inside jit,
donation safety, PRNG-key hygiene, recompile hazards) and
``sanitize.tracked`` (the key-reuse detector).  They check JAX idioms
the port does not have: it has no ``jax.jit``, no ``donate_argnums`` and
no threefry keys (dropout draws from ``torch.Generator`` streams).
"""
from .rules import available_rules, get_rule, register
from .rules.base import Finding, Rule
from .runner import main

__all__ = ["available_rules", "get_rule", "register", "Finding",
           "Rule", "main"]
