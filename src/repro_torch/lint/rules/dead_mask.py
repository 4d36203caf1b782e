"""R5 — dead-mask detection.

Historical bug class: a ``FedMethod`` whose ``stage_global_mask`` /
``stage_local_mask`` / ``keep_local`` / ``server_zero_rx`` regex
matches *zero* leaves of the adapter tree.  Nothing crashes — the
stage silently trains nothing (or shares everything), and only a
downstream parity test catches it, if one exists for that method ×
architecture combination.

A *project* rule: it imports the port's live registry
(``repro_torch.core.methods``), builds each method's adapter tree with
its own ``make_adapter`` on ``launch/train.abstract_base`` — meta
tensors, no FLOPs and no memory, the port's counterpart of the
reference's ``jax.eval_shape`` — for llama2-7b and one MoE config at
their SMOKE sizes, and evaluates every mask and regex of every method
against the real leaf paths.  A mask or regex matching zero leaves on a
config where the method has a non-empty adapter tree is a finding
anchored at the method's ``name=`` line in core/methods.py.

Methods whose adapter overlay is empty on a config are skipped for that
config.  Every ``stage_mask`` stage (local_pretrain / global / local)
must select at least one leaf — a non-pipeline method's global/local
stages fall back to ``train_mask``, so this cannot over-fire.
``keep_local=None`` is fine (nothing kept local is a valid choice), but
a *non-None* pattern matching nothing is dead by definition; the
server-zero pattern is resolved through
``aggregation.aggregate_zero_rx`` so inferred patterns are checked too.
"""
from __future__ import annotations

import ast
import re

from .base import Finding, ProjectContext, Rule

_CONFIGS = (
    ("llama2_7b", "repro_torch.configs.llama2_7b"),
    ("qwen3_moe_30b_a3b", "repro_torch.configs.qwen3_moe_30b_a3b"),
)


def evaluate_registry(configs=_CONFIGS) -> list[dict]:
    """Evaluate every registered method against meta adapter trees of
    ``configs``: each of the three ``stage_mask`` stages must select ≥ 1
    leaf, and each non-None ``keep_local`` / ``aggregate_zero_rx`` regex
    must match ≥ 1 leaf path.  Returns problem dicts ``{method, config,
    field, detail}``.  Importable on its own so tests can call it
    without the lint runner."""
    from repro_torch.core import aggregation as agg
    from repro_torch.core import methods as M
    from repro_torch.launch import train as T
    from repro_torch.utils import pytree as pt

    problems: list[dict] = []
    for cfg_name, cfg_mod in configs:
        mod = __import__(cfg_mod, fromlist=["SMOKE"])
        cfg = mod.SMOKE
        base = T.abstract_base(cfg)
        for name in M.available_methods():
            method = M.get_method(name)
            try:
                ad = method.make_adapter(base, cfg, None)
            except Exception as e:             # config/method mismatch
                problems.append(dict(
                    method=name, config=cfg_name, field="make_adapter",
                    detail=f"make_adapter failed: {e!r}"))
                continue
            paths = pt.tree_paths(ad)
            if not paths:
                continue                       # method n/a on this config
            # stage masks are path-predicate functions — they evaluate
            # fine on meta trees (only leaf *paths* are consulted)
            for stage in ("local_pretrain", "global", "local"):
                mask = method.stage_mask(ad, stage)
                n = sum(1 for v in pt.tree_leaves(mask) if v)
                if n == 0:
                    problems.append(dict(
                        method=name, config=cfg_name,
                        field=f"stage_mask[{stage}]",
                        detail=(f"selects 0 of {len(paths)} adapter "
                                f"leaves on {cfg_name} — the stage "
                                f"would silently train nothing")))
            for field, pattern in (
                    ("keep_local", method.keep_local),
                    ("server_zero_rx", agg.aggregate_zero_rx(method))):
                if pattern is None:
                    continue
                rx = re.compile(pattern)
                if not any(rx.search(p) for p in paths):
                    problems.append(dict(
                        method=name, config=cfg_name, field=field,
                        detail=(f"regex {pattern!r} matches 0 of "
                                f"{len(paths)} adapter leaf paths on "
                                f"{cfg_name} — dead pattern")))
    return problems


class DeadMask(Rule):
    code = "R5"
    name = "dead-mask"
    description = ("FedMethod mask/keep-local regex matches zero leaves "
                   "of the real adapter tree for llama2_7b or the MoE "
                   "config (stage silently trains/shares nothing)")

    # tests can point the rule at a different evaluator
    evaluate = staticmethod(evaluate_registry)

    def check_project(self, ctx: ProjectContext) -> list[Finding]:
        mod = ctx.module("repro_torch/core/methods.py")
        if mod is None:
            return []                          # partial lint run
        try:
            problems = type(self).evaluate()
        except ImportError as e:
            # torch (or the repo itself) not importable — static-only run
            return [mod.finding(
                "R5", mod.tree.body[0],
                f"dead-mask evaluation skipped: {e!r} (run with "
                f"PYTHONPATH=src and torch installed)")]
        anchors = self._name_lines(mod)
        out: list[Finding] = []
        for p in problems:
            anchor = anchors.get(p["method"], mod.tree.body[0])
            out.append(mod.finding(
                "R5", anchor,
                f"method `{p['method']}` {p['field']}: {p['detail']}"))
        return out

    def _name_lines(self, mod) -> dict[str, ast.AST]:
        """Map method name -> the ``name="..."`` keyword node of its
        register()/FedMethod(...) call in core/methods.py."""
        anchors: dict[str, ast.AST] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                for kw in node.keywords:
                    if kw.arg == "name" and isinstance(
                            kw.value, ast.Constant) and isinstance(
                            kw.value.value, str):
                        anchors.setdefault(kw.value.value, kw.value)
        return anchors
