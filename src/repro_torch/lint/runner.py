"""The repro_torch.lint runner: file discovery, suppression comments,
the baseline, and human/JSON reporting (port of ``repro/lint/runner.py``).

Usage (also via ``python -m repro_torch.lint``)::

    python -m repro_torch.lint src/repro_torch              # lint a tree
    python -m repro_torch.lint --json src/repro_torch       # machine output
    python -m repro_torch.lint --rules R5 path              # subset of rules
    python -m repro_torch.lint --write-baseline path        # accept findings

Suppression: append ``# lint: ok[R5] reason`` (or ``ok[R5,R6]``) to the
finding line, or put it on its own line directly above.  The reason is
mandatory — a bare ``ok[R5]`` does not suppress.

Baseline: ``.lint-baseline-torch.json`` at the repo root (next to
pyproject.toml) holds accepted findings as ``{rule, path, line_text,
note}``; the repo has none, so the port's analyzer accepts no finding.
It is not the reference's ``.lint-baseline.json``: that file's entries
name the JAX package's paths, so here each would be a stale entry.
Entries match on content, not line numbers, so they survive unrelated
edits; every entry MUST carry a non-empty ``note`` — the
one-line justification reviewers read.  Stale entries (no longer
produced by the analyzer) are reported as warnings so the file shrinks
over time.

Exit codes: 0 clean, 1 unsuppressed findings, 2 config error (bad
baseline, unjustified entries, unknown rule).
"""
from __future__ import annotations

import argparse
import json
import os
import re

from . import rules as R
from .rules.base import Finding, ModuleInfo, ProjectContext

BASELINE = ".lint-baseline-torch.json"
_SUPPRESS_RX = re.compile(
    r"#\s*lint:\s*ok\[([A-Z0-9, ]+)\]\s*(\S.*)?$")


def find_repo_root(start: str) -> str:
    """Nearest ancestor holding pyproject.toml (fallback: start)."""
    cur = os.path.abspath(start)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        if os.path.exists(os.path.join(cur, "pyproject.toml")):
            return cur
        parent = os.path.dirname(cur)
        if parent == cur:
            return os.path.abspath(start)
        cur = parent


def discover(paths: list[str]) -> list[str]:
    files: list[str] = []
    for p in paths:
        if os.path.isfile(p) and p.endswith(".py"):
            files.append(p)
        elif os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"
                               and not d.startswith(".")]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        files.append(os.path.join(dirpath, fn))
    return sorted(set(files))


def parse_modules(files: list[str], root: str) \
        -> tuple[list[ModuleInfo], list[Finding]]:
    mods: list[ModuleInfo] = []
    errors: list[Finding] = []
    for path in files:
        rel = os.path.relpath(os.path.abspath(path), root).replace(
            os.sep, "/")
        try:
            with open(path, encoding="utf-8") as f:
                source = f.read()
            mods.append(ModuleInfo(path=path, rel=rel, source=source))
        except (OSError, SyntaxError) as e:
            errors.append(Finding(
                rule="E0", path=rel, line=getattr(e, "lineno", 1) or 1,
                col=0, message=f"could not parse: {e}", line_text=""))
    return mods, errors


def run_rules(mods: list[ModuleInfo], root: str,
              codes: list[str]) -> list[Finding]:
    findings: list[Finding] = []
    ctx = ProjectContext(root=root, modules=mods)
    for code in codes:
        rule = R.get_rule(code)
        for mod in mods:
            findings.extend(rule.check_module(mod))
        findings.extend(rule.check_project(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def suppressed(mod_by_rel: dict[str, ModuleInfo], f: Finding) -> bool:
    """True if the finding line (or the line above) carries a justified
    ``# lint: ok[<rule>] reason`` comment."""
    mod = mod_by_rel.get(f.path)
    if mod is None:
        return False
    for lineno in (f.line, f.line - 1):
        text = mod.line_text(lineno)
        m = _SUPPRESS_RX.search(text)
        if m and m.group(2):                   # reason is mandatory
            codes = {c.strip() for c in m.group(1).split(",")}
            if f.rule in codes:
                return True
    return False


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path: str) -> tuple[list[dict], list[str]]:
    """Returns (entries, config_errors)."""
    if not os.path.exists(path):
        return [], []
    try:
        with open(path, encoding="utf-8") as f:
            entries = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [], [f"baseline {path}: unreadable ({e})"]
    errs: list[str] = []
    if not isinstance(entries, list):
        return [], [f"baseline {path}: expected a JSON list"]
    for i, e in enumerate(entries):
        missing = {"rule", "path", "line_text", "note"} - set(e)
        if missing:
            errs.append(f"baseline entry {i}: missing {sorted(missing)}")
        elif not str(e["note"]).strip() or \
                str(e["note"]).startswith("TODO"):
            errs.append(
                f"baseline entry {i} ({e['rule']} {e['path']}): every "
                f"entry needs a one-line justification in `note`")
    return entries, errs


def write_baseline(path: str, findings: list[Finding]) -> None:
    entries = [dict(rule=f.rule, path=f.path, line_text=f.line_text,
                    note="TODO: justify") for f in findings]
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(entries, fh, indent=2, ensure_ascii=False)
        fh.write("\n")


def apply_baseline(findings: list[Finding], entries: list[dict]) \
        -> tuple[list[Finding], list[Finding], list[dict]]:
    """Split into (new, baselined, stale-entries).  Matching is by
    (rule, path, line_text) with multiplicity."""
    pool: dict[tuple, int] = {}
    for e in entries:
        k = (e["rule"], e["path"], e["line_text"])
        pool[k] = pool.get(k, 0) + 1
    new: list[Finding] = []
    matched: list[Finding] = []
    for f in findings:
        k = f.sig
        if pool.get(k, 0) > 0:
            pool[k] -= 1
            matched.append(f)
        else:
            new.append(f)
    stale = []
    for e in entries:
        k = (e["rule"], e["path"], e["line_text"])
        if pool.get(k, 0) > 0:
            pool[k] -= 1
            stale.append(e)
    return new, matched, stale


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="repo-aware static analyzer of the PyTorch port (R5)")
    ap.add_argument("paths", nargs="*", default=[],
                    help="files or directories to lint")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable JSON report on stdout")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule codes (default: all)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: "
                         "<root>/.lint-baseline-torch.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline file")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings into the baseline "
                         "(notes start as TODO and must be filled in)")
    args = ap.parse_args(argv)

    if args.list_rules:
        for code in R.available_rules():
            rule = R.get_rule(code)
            print(f"{code}  {rule.name}: {rule.description}")
        return 0
    if not args.paths:
        ap.error("no paths given (try: python -m repro_torch.lint "
                 "src/repro_torch)")

    codes = R.available_rules()
    if args.rules:
        codes = [c.strip() for c in args.rules.split(",") if c.strip()]
        for c in codes:
            try:
                R.get_rule(c)
            except ValueError as e:
                print(f"error: {e}")
                return 2

    root = find_repo_root(args.paths[0])
    files = discover(args.paths)
    mods, parse_errors = parse_modules(files, root)
    findings = parse_errors + run_rules(mods, root, codes)

    mod_by_rel = {m.rel: m for m in mods}
    findings = [f for f in findings if not suppressed(mod_by_rel, f)]

    baseline_path = args.baseline or os.path.join(
        root, BASELINE)
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} entries to {baseline_path} — fill "
              f"in every `note` before committing")
        return 0

    entries: list[dict] = []
    config_errors: list[str] = []
    if not args.no_baseline:
        entries, config_errors = load_baseline(baseline_path)
    new, matched, stale = apply_baseline(findings, entries)

    if args.json:
        print(json.dumps(dict(
            findings=[f.to_dict() for f in new],
            baselined=[f.to_dict() for f in matched],
            stale_baseline=stale,
            config_errors=config_errors,
            files=len(files), rules=codes), indent=2))
    else:
        for f in new:
            print(f.render())
        for e in stale:
            print(f"warning: stale baseline entry {e['rule']} "
                  f"{e['path']}: {e['line_text']!r} — remove it")
        for err in config_errors:
            print(f"error: {err}")
        n = len(new)
        print(f"repro_torch.lint: {len(files)} files, rules "
              f"{','.join(codes)}: {n} finding(s), "
              f"{len(matched)} baselined, {len(stale)} stale")
    if config_errors:
        return 2
    return 1 if new else 0
