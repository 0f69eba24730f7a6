"""The pass framework behind `python -m kcmc_tpu_torch check` (the
port's copy of kcmc_tpu/analysis/core.py).

The port's load-bearing invariants (resume-signature neutrality, the
"card work only on non-daemon threads" rule, canonical trace-span
names, the lock order of the serving plane) are contracts written in
comments. This module turns them into checked ones: a shared AST
index over the package, passes that walk it and emit `Finding`s, and
a checked-in baseline of accepted findings, so the gate is "no NEW
findings", never "rewrite history first".

Design constraints:

* **stdlib only** - `ast` + `json`; the checker runs in a bare venv
  before torch imports (and never pays CUDA start-up).
* **sources in, findings out** - passes see a `ModuleIndex`, which the
  tests build from in-memory snippets (`ModuleIndex.from_sources`) and
  the command builds from the package tree, so every rule is shown on
  a known-bad snippet.
* **stable finding keys** - baselines match on (rule, path, message
  prefix), never line numbers, so unrelated edits don't churn the
  baseline file.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os


SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One invariant violation, anchored to file:line.

    `message` must be stable under unrelated edits (it participates in
    the baseline key); put volatile detail (line numbers, counts) in
    `detail`, never in `message`.
    """

    rule: str
    path: str  # repo-relative, forward slashes
    line: int
    severity: str  # "error" | "warning"
    message: str
    detail: str = ""

    @property
    def key(self) -> str:
        """Baseline identity: line numbers deliberately excluded."""
        return f"{self.rule}|{self.path}|{self.message}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}"
        s = f"{loc}: {self.severity} [{self.rule}] {self.message}"
        if self.detail:
            s += f" ({self.detail})"
        return s

    def as_dict(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": int(self.line),
            "severity": self.severity,
            "message": self.message,
            "detail": self.detail,
        }


@dataclasses.dataclass(frozen=True)
class Module:
    """One parsed source file of the package under analysis."""

    path: str  # repo-relative, forward slashes
    source: str
    tree: ast.Module


class ModuleIndex:
    """Parse-once index shared by every pass.

    Holds {relpath: Module} plus the docs the passes consult (an API
    document for the config-documentation rule, where one is given). Construction parses each file
    exactly once; a file with a syntax error becomes a finding, not a
    crash (`parse_errors`).
    """

    def __init__(self):
        self.modules: dict[str, Module] = {}
        self.docs: dict[str, str] = {}
        self.parse_errors: list[Finding] = []

    # -- construction ------------------------------------------------------

    @classmethod
    def from_sources(
        cls, sources: dict[str, str], docs: dict[str, str] | None = None
    ) -> "ModuleIndex":
        """Build from in-memory {relpath: source} — the test seam."""
        idx = cls()
        for path, src in sources.items():
            idx._add(path.replace(os.sep, "/"), src)
        idx.docs = dict(docs or {})
        return idx

    @classmethod
    def from_package(cls, root: str) -> "ModuleIndex":
        """Walk `root`'s `kcmc_tpu_torch/` package tree on disk.

        `root` is the repo root, the directory holding `kcmc_tpu_torch/`.
        No documents are read: `docs/` belongs to the JAX package, so
        the config pass's documentation half has nothing to hold the
        port's fields against and stays silent.
        """
        idx = cls()
        pkg = os.path.join(root, "kcmc_tpu_torch")
        for dirpath, dirnames, filenames in os.walk(pkg):
            dirnames[:] = sorted(
                d for d in dirnames if d != "__pycache__"
            )
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root).replace(os.sep, "/")
                try:
                    with open(full, encoding="utf-8") as f:
                        idx._add(rel, f.read())
                except OSError:
                    continue  # unreadable file: not this checker's story
        return idx

    def _add(self, rel: str, source: str) -> None:
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            self.parse_errors.append(
                Finding(
                    rule="parse",
                    path=rel,
                    line=int(e.lineno or 0),
                    severity="error",
                    message=f"syntax error: {e.msg}",
                )
            )
            return
        self.modules[rel] = Module(path=rel, source=source, tree=tree)

    # -- access ------------------------------------------------------------

    def get(self, rel: str) -> Module | None:
        return self.modules.get(rel)

    def match(self, prefix: str = "", suffix: str = ".py") -> list[Module]:
        """Modules whose path starts/ends with the given affixes."""
        return [
            m
            for p, m in sorted(self.modules.items())
            if p.startswith(prefix) and p.endswith(suffix)
        ]

    def __iter__(self):
        return iter(self.modules.values())


# -- shared AST helpers (used by several passes) ---------------------------


def attr_chain(node: ast.AST) -> str:
    """Dotted name of a Name/Attribute chain: `torch.cuda.synchronize`
    -> "torch.cuda.synchronize"; anything non-static contributes "?"."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    else:
        parts.append("?")
    return ".".join(reversed(parts))


def str_const(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def str_set_from(node: ast.AST) -> set[str] | None:
    """String members of a literal registry value:
    frozenset({...}) / {...} / (...) / [...] of string constants."""
    if isinstance(node, ast.Call) and attr_chain(node.func).endswith(
        "frozenset"
    ):
        if not node.args:
            return set()
        node = node.args[0]
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        out = set()
        for elt in node.elts:
            s = str_const(elt)
            if s is None:
                return None
            out.add(s)
        return out
    return None


class FunctionTable(ast.NodeVisitor):
    """All function/method defs of a module, by name and by class.

    `functions` maps bare name -> [FunctionDef] (module-level AND
    nested — resolution by bare name is deliberately flat: the passes
    reason about *locally reachable* code, and this repo does not reuse
    a helper name with different meanings inside one module).
    `methods` maps class name -> {method name -> FunctionDef}.
    """

    def __init__(self, tree: ast.Module):
        self.functions: dict[str, list[ast.FunctionDef]] = {}
        self.methods: dict[str, dict[str, ast.FunctionDef]] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        self._class_stack: list[str] = []
        self.visit(tree)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.classes[node.name] = node
        self._class_stack.append(node.name)
        self.methods.setdefault(node.name, {})
        self.generic_visit(node)
        self._class_stack.pop()

    def _def(self, node) -> None:
        self.functions.setdefault(node.name, []).append(node)
        if self._class_stack:
            self.methods[self._class_stack[-1]].setdefault(node.name, node)
        self.generic_visit(node)

    visit_FunctionDef = _def
    visit_AsyncFunctionDef = _def


def called_names(fn: ast.FunctionDef) -> list[tuple[str, int]]:
    """Every call inside `fn` as (dotted name, line) — `self.m()` yields
    "self.m", `np.asarray()` yields "np.asarray"."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call):
            out.append((attr_chain(node.func), node.lineno))
    return out


def reachable_functions(
    table: FunctionTable,
    root: ast.FunctionDef,
    cls: str | None = None,
    _seen: set | None = None,
) -> list[ast.FunctionDef]:
    """`root` plus the local call-graph closure: callees resolved by
    bare name among module functions, and by `self.m` among `cls`'s
    methods. Cross-module calls are out of scope by design — passes
    reason about what a reader of THIS file can verify."""
    seen = _seen if _seen is not None else set()
    if id(root) in seen:
        return []
    seen.add(id(root))
    out = [root]
    for name, _line in called_names(root):
        target: ast.FunctionDef | None = None
        if name.startswith("self.") and cls is not None:
            target = table.methods.get(cls, {}).get(name[5:])
        elif "." not in name:
            cands = table.functions.get(name)
            target = cands[0] if cands else None
        if target is not None:
            out.extend(reachable_functions(table, target, cls, seen))
    return out


def enclosing_class(tree: ast.Module, fn: ast.FunctionDef) -> str | None:
    """Name of the class a function is (transitively) defined inside."""
    for cls in [n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)]:
        for sub in ast.walk(cls):
            if sub is fn:
                return cls.name
    return None


# -- baseline --------------------------------------------------------------


@dataclasses.dataclass
class BaselineEntry:
    rule: str
    path: str
    match: str  # message prefix
    reason: str  # one-line justification — REQUIRED
    used: bool = False

    def matches(self, f: Finding) -> bool:
        return (
            f.rule == self.rule
            and f.path == self.path
            and f.message.startswith(self.match)
        )


class Baseline:
    """The checked-in set of accepted findings.

    Every entry carries a one-line `reason` — a baseline without a
    justification is itself a finding (`baseline` rule), so accepted
    debt stays explained, not just silenced.
    """

    KIND = "kcmc_check_baseline"

    def __init__(self, entries: list[BaselineEntry] | None = None):
        self.entries = list(entries or [])

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
        if data.get("kind") != cls.KIND:
            raise ValueError(
                f"{path} is not a {cls.KIND} file (kind="
                f"{data.get('kind')!r})"
            )
        return cls(
            [
                BaselineEntry(
                    rule=e["rule"],
                    path=e["path"],
                    match=e["match"],
                    reason=e.get("reason", ""),
                )
                for e in data.get("entries", [])
            ]
        )

    def as_dict(self) -> dict:
        return {
            "kind": self.KIND,
            "entries": [
                {
                    "rule": e.rule,
                    "path": e.path,
                    "match": e.match,
                    "reason": e.reason,
                }
                for e in self.entries
            ],
        }

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=False)
            f.write("\n")

    def split(
        self, findings: list[Finding]
    ) -> tuple[list[Finding], list[Finding]]:
        """(new, baselined). Marks entries used for staleness report."""
        new, accepted = [], []
        for f in findings:
            hit = None
            for e in self.entries:
                if e.matches(f):
                    hit = e
                    break
            if hit is None:
                new.append(f)
            else:
                hit.used = True
                accepted.append(f)
        return new, accepted

    def problems(self) -> list[Finding]:
        """Baseline hygiene findings: missing reasons, stale entries."""
        out = []
        for e in self.entries:
            if not e.reason.strip():
                out.append(
                    Finding(
                        rule="baseline",
                        path=e.path,
                        line=0,
                        severity="error",
                        message=(
                            f"baseline entry for [{e.rule}] "
                            f"{e.match!r} has no justification"
                        ),
                    )
                )
            elif not e.used:
                out.append(
                    Finding(
                        rule="baseline",
                        path=e.path,
                        line=0,
                        severity="warning",
                        message=(
                            f"stale baseline entry: [{e.rule}] "
                            f"{e.match!r} no longer fires"
                        ),
                    )
                )
        return out


# -- runner ----------------------------------------------------------------


@dataclasses.dataclass
class CheckResult:
    findings: list[Finding]  # everything the passes emitted
    new: list[Finding]  # not covered by the baseline — the CI gate
    baselined: list[Finding]
    baseline_problems: list[Finding]
    passes: list[str]

    @property
    def exit_code(self) -> int:
        blocking = [f for f in self.new if f.severity == "error"]
        blocking += [
            f for f in self.baseline_problems if f.severity == "error"
        ]
        return 1 if blocking else 0

    def summary(self) -> dict:
        return {
            "kind": "kcmc_check",
            "passes": self.passes,
            "findings": len(self.findings),
            "new": len(self.new),
            "new_errors": sum(
                1 for f in self.new if f.severity == "error"
            ),
            "baselined": len(self.baselined),
            "stale_baseline": sum(
                1
                for f in self.baseline_problems
                if f.message.startswith("stale")
            ),
            "ok": self.exit_code == 0,
        }

    def as_dict(self) -> dict:
        d = self.summary()
        d["new_findings"] = [f.as_dict() for f in self.new]
        d["baselined_findings"] = [f.as_dict() for f in self.baselined]
        d["baseline_problems"] = [
            f.as_dict() for f in self.baseline_problems
        ]
        return d


def run_passes(
    index: ModuleIndex,
    passes: list,
    baseline: Baseline | None = None,
    cache=None,
) -> CheckResult:
    """Run every pass over the shared index and gate against the
    baseline. Findings sort by (path, line, rule) for stable output.
    `cache` (analysis/cache.CheckCache) replays content-hash-matched
    results instead of re-running a pass; baseline splitting always
    happens fresh."""
    findings = list(index.parse_errors)
    names = []
    for p in passes:
        names.append(p.name)
        if cache is not None:
            findings.extend(cache.findings_for(p, index))
        else:
            findings.extend(p.run(index))
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    bl = baseline or Baseline()
    new, accepted = bl.split(findings)
    return CheckResult(
        findings=findings,
        new=new,
        baselined=accepted,
        baseline_problems=bl.problems(),
        passes=names,
    )
