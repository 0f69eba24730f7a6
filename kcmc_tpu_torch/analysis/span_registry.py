"""Pass 4 — span/name registry (`span-registry`); the port's copy of
kcmc_tpu/analysis/span_registry.py.

`obs/report.py` renders whatever the rest of the package recorded: if a
producer renames a trace span or a `timing[...]` key, the report (and
every dashboard built on the trace JSON) silently drops the series —
telemetry drift with no failing test. The canonical name registry
(`kcmc_tpu_torch/obs/registry.py`) is the single source of truth; this
pass
checks both directions:

* every string-literal span name at an emission site —
  `tracer.complete/span/instant/counter(...)`, `timer.stage/stall(...)`,
  `timer.add_stall(...)` — is registered;
* every string-literal `timing["key"]` store AND `timing.get("key")` /
  `timing["key"]` read (the report/CLI consumer side) is registered;
* registered span names that no emission site uses anymore are flagged
  stale (warning), so the registry can't rot into a name museum.

Dynamic names (a variable first argument) are skipped: the registry
governs the literal vocabulary, and a dynamic site (the plan runtime's
build-span pick) chooses between registered literals.
"""

from __future__ import annotations

import ast

from kcmc_tpu_torch.analysis.core import (
    Finding,
    ModuleIndex,
    attr_chain,
    str_const,
    str_set_from,
)

REGISTRY_PATH = "kcmc_tpu_torch/obs/registry.py"
SPAN_SET_NAME = "SPAN_NAMES"
TIMING_SET_NAME = "TIMING_KEYS"

# method name -> emits a span-like name as first string arg.
# `observe` is the latency-segment recorder (obs/latency.py
# SegmentLatencies.observe) — its first argument is a lifecycle
# segment name, governed by REQUEST_SEGMENTS/JOURNAL_SPANS in the
# registry so an unregistered segment fails this pass.
SPAN_EMITTERS = frozenset(
    {
        "complete", "span", "instant", "counter", "stage", "stall",
        "add_stall", "observe",
    }
)


def _eval_set(node: ast.AST, env: dict[str, set[str]]) -> set[str] | None:
    """Resolve a registry value statically: a literal frozenset/set, a
    Name bound to one earlier in the module, or a `|` union of such."""
    lit = str_set_from(node)
    if lit is not None:
        return lit
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        left = _eval_set(node.left, env)
        right = _eval_set(node.right, env)
        if left is not None and right is not None:
            return left | right
    return None


def _registry_sets(index: ModuleIndex, path: str):
    mod = index.get(path)
    if mod is None:
        return None, None, 0
    env: dict[str, set[str]] = {}
    spans = timing = None
    line = 0
    for stmt in mod.tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        for t in stmt.targets:
            if not isinstance(t, ast.Name):
                continue
            value = _eval_set(stmt.value, env)
            if value is not None:
                env[t.id] = value
            if t.id == SPAN_SET_NAME:
                spans = value
                line = stmt.lineno
            elif t.id == TIMING_SET_NAME:
                timing = value
    return spans, timing, line


class SpanRegistryPass:
    name = "span-registry"

    def __init__(self, registry_path: str = REGISTRY_PATH):
        self.registry_path = registry_path

    def run(self, index: ModuleIndex) -> list[Finding]:
        spans, timing, _line = _registry_sets(index, self.registry_path)
        if spans is None or timing is None:
            return [
                Finding(
                    rule=self.name,
                    path=self.registry_path,
                    line=0,
                    severity="error",
                    message=(
                        f"canonical registry not found: {self.registry_path}"
                        f" must define literal {SPAN_SET_NAME} and "
                        f"{TIMING_SET_NAME} sets"
                    ),
                )
            ]
        out: list[Finding] = []
        used_spans: set[str] = set()
        for mod in index:
            if mod.path == self.registry_path:
                continue
            for node in ast.walk(mod.tree):
                # staleness accounting is deliberately string-level:
                # dynamic sites pick between registered literals (the
                # plan runtime's build-span pick), so ANY occurrence of
                # the literal in a module keeps the name alive
                if (
                    isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value in spans
                ):
                    used_spans.add(node.value)
                # emission sites: obj.<emitter>("literal", ...)
                if isinstance(node, ast.Call) and isinstance(
                    node.func, ast.Attribute
                ):
                    meth = node.func.attr
                    if meth in SPAN_EMITTERS and node.args:
                        name = str_const(node.args[0])
                        if name is not None:
                            used_spans.add(name)
                            if name not in spans:
                                out.append(
                                    Finding(
                                        rule=self.name,
                                        path=mod.path,
                                        line=node.lineno,
                                        severity="error",
                                        message=(
                                            f"span name '{name}' "
                                            f"(via .{meth}) is not in "
                                            f"{SPAN_SET_NAME}"
                                        ),
                                        detail=(
                                            "register it in "
                                            f"{self.registry_path} so "
                                            "obs/report.py and trace "
                                            "consumers see it"
                                        ),
                                    )
                                )
                # timing reads: timing.get("key") / res.timing.get("key")
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and node.args
                    and attr_chain(node.func.value).split(".")[-1]
                    == "timing"
                ):
                    key = str_const(node.args[0])
                    if key is not None and key not in timing:
                        out.append(
                            self._timing_finding(mod, node.lineno, key)
                        )
                # timing stores/reads by subscript: timing["key"]
                if (
                    isinstance(node, ast.Subscript)
                    and attr_chain(node.value).split(".")[-1] == "timing"
                ):
                    key = str_const(node.slice)
                    if key is not None and key not in timing:
                        out.append(
                            self._timing_finding(mod, node.lineno, key)
                        )
        for stale in sorted(spans - used_spans):
            out.append(
                Finding(
                    rule=self.name,
                    path=self.registry_path,
                    line=0,
                    severity="warning",
                    message=(
                        f"registered span name '{stale}' has no "
                        "emission site left"
                    ),
                    detail="remove it or restore the producer",
                )
            )
        # one finding per (path, line, message)
        uniq: dict[tuple, Finding] = {}
        for f in out:
            uniq.setdefault((f.path, f.line, f.message), f)
        return list(uniq.values())

    def _timing_finding(self, mod, line: int, key: str) -> Finding:
        return Finding(
            rule=self.name,
            path=mod.path,
            line=line,
            severity="error",
            message=(
                f"timing key '{key}' is not in {TIMING_SET_NAME}"
            ),
            detail=f"register it in {self.registry_path}",
        )
