"""The port's analyzer and sanitizer (``repro_torch.lint``) against the
JAX package's (``repro.lint``), on the CPU.

- R5 on the port's registry finds nothing, and for every method and both
  configs (llama2-7b and qwen3-moe-30b-a3b at SMOKE) the number of leaves
  each stage mask selects and the set of paths each keep-local and
  server-zero regex matches equal the reference's, the port's trees on
  meta tensors and the reference's from ``jax.eval_shape``;
- a dead keep-local regex and a dead stage mask, injected as the
  reference's tests inject them, give the reference's problem dicts, and
  the rule anchors them in the port's core/methods.py;
- ``main(["src/repro_torch"])`` returns 0 with no stale baseline entry;
- suppressions and the baseline split the same synthetic findings as the
  reference's; ``nan_guard`` names the reference's paths.
All comparisons are exact.
"""
import json
import re
from functools import partial
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.core import aggregation as j_agg
from repro.core import methods as j_methods
from repro.core import peft as j_peft
from repro.launch import train as j_train
from repro.lint import runner as j_runner
from repro.lint import sanitize as j_sanitize
from repro.lint.rules import base as j_base
from repro.lint.rules.dead_mask import evaluate_registry as j_evaluate
from repro.utils import pytree as jpt
from repro_torch.core import aggregation as t_agg
from repro_torch.core import methods as t_methods
from repro_torch.core import peft as t_peft
from repro_torch.launch import train as t_train
from repro_torch.lint import main as t_main
from repro_torch.lint import runner as t_runner
from repro_torch.lint import sanitize as t_sanitize
from repro_torch.lint.rules import available_rules, get_rule
from repro_torch.lint.rules import base as t_base
from repro_torch.lint.rules.dead_mask import evaluate_registry
from repro_torch.utils import pytree as tpt

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ("llama2_7b", "qwen3_moe_30b_a3b")
LLAMA_ONLY = {"j": (("llama2_7b", "repro.configs.llama2_7b"),),
              "t": (("llama2_7b", "repro_torch.configs.llama2_7b"),)}
STAGES = ("local_pretrain", "global", "local")


def smoke(pkg, name):
    return __import__(f"{pkg}.configs.{name}", fromlist=["SMOKE"]).SMOKE


def selections(method, ad, paths, leaves, zero_rx):
    """What each mask and regex of ``method`` selects on one tree."""
    out = {stage: sum(1 for v in leaves(method.stage_mask(ad, stage)) if v)
           for stage in STAGES}
    for field, pattern in (("keep_local", method.keep_local),
                           ("server_zero_rx", zero_rx(method))):
        out[field] = (None if pattern is None else
                      sorted(p for p in paths if re.search(pattern, p)))
    return out


def test_r5_on_the_port_finds_nothing():
    assert available_rules() == ["R5"]
    assert evaluate_registry() == []


@pytest.mark.parametrize("cfg_name", CONFIGS)
def test_r5_selects_the_references_leaves(cfg_name):
    jc, tc = smoke("repro", cfg_name), smoke("repro_torch", cfg_name)
    jbase, tbase = j_train.abstract_base(jc), t_train.abstract_base(tc)
    assert t_methods.available_methods() == j_methods.available_methods()
    for name in t_methods.available_methods():
        jm, tm = j_methods.get_method(name), t_methods.get_method(name)
        jad = jax.eval_shape(lambda: jm.make_adapter(
            jbase, jc, jax.random.PRNGKey(0)))
        tad = tm.make_adapter(tbase, tc, None)
        jpaths, tpaths = jpt.tree_paths(jad), tpt.tree_paths(tad)
        assert sorted(tpaths) == sorted(jpaths), name
        if not tpaths:
            continue                    # the method has no leaves here
        assert {x.device.type for x in tpt.tree_leaves(tad)} == {"meta"}
        got = selections(tm, tad, tpaths, tpt.tree_leaves,
                         t_agg.aggregate_zero_rx)
        want = selections(jm, jad, jpaths, jax.tree_util.tree_leaves,
                          j_agg.aggregate_zero_rx)
        assert got == want, (cfg_name, name)
        assert all(got[s] > 0 for s in STAGES), (cfg_name, name)


def inject(pkg_methods, pkg_peft, pkg_pt, kind):
    """The reference tests' dead fixtures (tests/test_lint_rules.py), in
    one package's registry."""
    if kind == "keep_local":
        m = pkg_methods.FedMethod(
            name="_lint_dead_fixture",
            make_adapter=partial(pkg_peft.add_lora, decomposed=False),
            train_mask=pkg_peft.mask_all,
            keep_local=r"no_such_leaf_anywhere$")
    else:
        m = pkg_methods.FedMethod(
            name="_lint_dead_stage",
            make_adapter=partial(pkg_peft.add_lora, decomposed=False),
            train_mask=pkg_peft.mask_all,
            global_mask=lambda ad: pkg_pt.path_mask(ad, lambda p: False))
    return pkg_methods.register(m)


@pytest.mark.parametrize("kind", ["keep_local", "stage_mask"])
def test_dead_fixtures_give_the_references_problems(kind):
    jm = inject(j_methods, j_peft, jpt, kind)
    tm = inject(t_methods, t_peft, tpt, kind)
    try:
        want = j_evaluate(configs=LLAMA_ONLY["j"])
        got = evaluate_registry(configs=LLAMA_ONLY["t"])
        rule = get_rule("R5")
        ctx = t_base.ProjectContext(root=str(ROOT), modules=[
            t_base.ModuleInfo(str(p), p.relative_to(ROOT).as_posix(),
                              p.read_text())
            for p in [ROOT / "src/repro_torch/core/methods.py"]])
        findings = rule.check_project(ctx)
    finally:
        j_methods._REGISTRY.pop(jm.name)
        t_methods._REGISTRY.pop(tm.name)
    assert got == want and len(got) == 1
    field = "keep_local" if kind == "keep_local" else "stage_mask[global]"
    assert got[0]["method"] == tm.name and got[0]["field"] == field
    # one finding a config; the fixture has no name= line in
    # core/methods.py, so each sits on the module's first statement
    assert [(f.rule, f.path, f.line) for f in findings] == [
        ("R5", "src/repro_torch/core/methods.py", 1)] * 2
    assert all(tm.name in f.message for f in findings)
    assert evaluate_registry(configs=LLAMA_ONLY["t"]) == []


def test_lint_main_on_the_port_is_clean(capsys):
    assert t_main([str(ROOT / "src/repro_torch")]) == 0
    out = capsys.readouterr().out
    assert "0 finding(s), 0 baselined, 0 stale" in out
    assert "warning" not in out
    assert t_main(["--json", str(ROOT / "src/repro_torch")]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert (rep["findings"], rep["stale_baseline"], rep["rules"]) == \
        ([], [], ["R5"])
    assert t_main(["--list-rules"]) == 0
    assert capsys.readouterr().out.startswith("R5  dead-mask:")
    assert t_main(["--rules", "R1", str(ROOT / "src/repro_torch")]) == 2


SOURCE = """x = 1
y = 2  # lint: ok[R5] the fixture's reason
# lint: ok[R5,R9] on the line above
z = 3
w = 4  # lint: ok[R5]
"""


def test_suppressions_and_baseline_agree_with_the_reference():
    mods = {pkg: base.ModuleInfo("a/b.py", "a/b.py", SOURCE)
            for pkg, base in (("j", j_base), ("t", t_base))}
    spec = [("R5", 1), ("R5", 2), ("R5", 4), ("R9", 4), ("R5", 5),
            ("R1", 2), ("R5", 4)]

    def findings(base, mod):
        return [base.Finding(rule=r, path="a/b.py", line=ln, col=0,
                             message="m", line_text=mod.line_text(ln))
                for r, ln in spec]
    jf, tf = findings(j_base, mods["j"]), findings(t_base, mods["t"])
    js = [j_runner.suppressed({"a/b.py": mods["j"]}, f) for f in jf]
    ts = [t_runner.suppressed({"a/b.py": mods["t"]}, f) for f in tf]
    assert ts == js == [False, True, True, True, False, False, True]
    entries = [dict(rule="R5", path="a/b.py", line_text="z = 3", note="n"),
               dict(rule="R5", path="a/b.py", line_text="x = 1", note="n"),
               dict(rule="R5", path="a/b.py", line_text="gone", note="n")]
    jn, jm, jst = j_runner.apply_baseline(jf, entries)
    tn, tm, tst = t_runner.apply_baseline(tf, entries)
    assert [f.to_dict() for f in tn] == [f.to_dict() for f in jn]
    assert [f.to_dict() for f in tm] == [f.to_dict() for f in jm]
    assert tst == jst == [entries[2]]


def test_nan_guard_names_the_references_paths():
    tree = {"a": {"w": [1.0, float("nan")], "b": [1.0, 2.0]},
            "c": {"d": [float("inf")], "e": [0.5]}, "n": [3, 4]}
    jt = jax.tree.map(lambda v: jnp.asarray(v), tree,
                      is_leaf=lambda v: isinstance(v, list))
    tt = {k: {kk: torch.tensor(vv) for kk, vv in v.items()}
          if isinstance(v, dict) else torch.tensor(v)
          for k, v in tree.items()}
    with pytest.raises(j_sanitize.NonFiniteError) as je:
        j_sanitize.nan_guard(jt, "g")
    with pytest.raises(t_sanitize.NonFiniteError) as te:
        t_sanitize.nan_guard(tt, "g")
    assert te.value.bad_paths == je.value.bad_paths == ["a/w", "c/d"]
    assert str(te.value) == str(je.value)
    ok = {"x": torch.ones(3, dtype=torch.bfloat16),
          "m": torch.empty(2, device="meta"), "i": np.arange(3)}
    assert t_sanitize.nan_guard(ok) is ok
    assert t_sanitize.guard("r")(lambda: ok)() is ok
    with pytest.raises(t_sanitize.NonFiniteError, match="'r'"):
        t_sanitize.guard("r")(lambda: {"x": torch.full((2,), np.inf)})()
