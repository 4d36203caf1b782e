"""Shared infrastructure for repro_torch.lint rules: findings, the rule
base class and the parsed source file.

Every rule is a class with a unique ``code``, registered in
``repro_torch.lint.rules`` exactly like a ``FedMethod`` in
``core.methods``.  A rule implements either or both hooks:

  check_module(mod)   called once per parsed source file (AST rules)
  check_project(ctx)  called once per lint run (whole-repo rules, e.g.
                      R5's live-registry dead-mask evaluation)

The reference's jit-reachability index (scopes, aliases, traced entry
points) serves its JAX rules R1–R4 only and has no counterpart here.
"""
from __future__ import annotations

import ast
import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Finding:
    """One analyzer hit.  ``path`` is repo-relative (posix separators);
    ``line``/``col`` are 1-based/0-based as in CPython's ast."""
    rule: str
    path: str
    line: int
    col: int
    message: str
    # the stripped source line the finding sits on — baseline entries
    # match on (rule, path, line_text) so they survive line-number drift
    line_text: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @property
    def sig(self) -> tuple:
        return (self.rule, self.path, self.line_text)

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class Rule:
    """Base class for lint rules (see module docstring for the hooks)."""
    code: str = "R0"
    name: str = ""
    description: str = ""

    def check_module(self, mod: "ModuleInfo") -> list[Finding]:
        return []

    def check_project(self, ctx: "ProjectContext") -> list[Finding]:
        return []


@dataclasses.dataclass
class ProjectContext:
    """Whole-run context handed to ``Rule.check_project``."""
    root: str                      # repo root (directory of pyproject.toml)
    modules: list                  # every parsed ModuleInfo in the run

    def module(self, rel_suffix: str) -> Optional["ModuleInfo"]:
        """Find a parsed module by repo-relative path suffix."""
        for m in self.modules:
            if m.rel.endswith(rel_suffix):
                return m
        return None


class ModuleInfo:
    """One parsed source file."""

    def __init__(self, path: str, rel: str, source: str):
        self.path = path
        self.rel = rel
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node, message: str) -> Finding:
        return Finding(rule=rule, path=self.rel, line=node.lineno,
                       col=node.col_offset, message=message,
                       line_text=self.line_text(node.lineno))
