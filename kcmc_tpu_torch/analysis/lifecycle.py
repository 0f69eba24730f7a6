"""Pass 7 — resource lifecycle (`lifecycle`); the port's copy of
kcmc_tpu/analysis/lifecycle.py.

Every acquired resource must reach its release on every path. The
leak classes that matter here are the package's own: a started
`Thread` never joined, a `DecodePool`/executor never shut down, a
socket or file opened outside a `with`, a `RunTelemetry` whose
artifact-path claims outlive a failed construction. The pass knows
three ownership shapes:

* **scoped** (a local variable): the acquisition must be a context
  manager (`with …`), or the variable must be released in a `finally`
  (releases only on the straight-line path are a warning — the
  exception path leaks), or the value must ESCAPE (returned, stored on
  `self`/a global/container, passed onward) — escaped ownership is the
  receiver's problem;
* **object-held** (`self._x = …`): some method of the class must
  release `self._x` (`join`/`shutdown`/`close`/`stop`/`finish`); a
  class that acquires but can never release is an error;
* **process-lifetime** (stored in a module global): the module must
  register an `atexit` hook — the feeder's shared-pool registry is the
  canonical shape.

Threads: `daemon=True` threads are exempt from the join requirement
(they are backstops by contract — the daemon-cuda rule bounds what they
may touch); a non-daemon thread that is started and neither stored nor
joined relies on the interpreter's exit join and gets a warning, not
an error.

The runtime half of this contract is
`kcmc_tpu_torch/analysis/sanitize.py`'s per-test leak checker — static for the shapes the AST can see, runtime
for the rest.
"""

from __future__ import annotations

import ast

from kcmc_tpu_torch.analysis.callgraph import ProgramGraph
from kcmc_tpu_torch.analysis.core import Finding, ModuleIndex
from kcmc_tpu_torch.analysis.lock_discipline import _self_attr, attr_chain

# Ctor chain (exact or trailing name) -> (resource kind, release names)
STDLIB_RESOURCES = {
    "threading.Thread": ("thread", ("join",)),
    "ThreadPoolExecutor": ("executor", ("shutdown",)),
    "ProcessPoolExecutor": ("executor", ("shutdown",)),
    "socket.socket": ("socket", ("close", "detach")),
    "socket.create_connection": ("socket", ("close", "detach")),
    "open": ("file", ("close",)),
}

# Program-defined resource classes (constructed OR factory-built) and
# their release methods. Kept explicit: a class with a `close()` is not
# automatically a tracked resource — these are the ones whose leak
# takes worker threads, sockets, or artifact-path claims with it.
PROGRAM_RESOURCES = {
    "DecodePool": ("decode pool", ("shutdown",)),
    "AsyncBatchWriter": ("async writer", ("close",)),
    "Heartbeat": ("heartbeat", ("stop",)),
    "RunTelemetry": ("telemetry", ("finish", "close")),
    "FrameRecordStream": ("record stream", ("close",)),
    "StreamScheduler": ("scheduler", ("stop",)),
    "ServeServer": ("server", ("stop",)),
}

# Factory classmethods that acquire (RunTelemetry.begin returns a live
# claim-holding telemetry or None).
FACTORY_METHODS = {("RunTelemetry", "begin")}

RELEASE_NAMES = frozenset(
    n
    for _k, names in list(STDLIB_RESOURCES.values())
    + list(PROGRAM_RESOURCES.values())
    for n in names
)


def _classify_ctor(graph: ProgramGraph, path: str, cls, call: ast.Call):
    """(kind, releases, label) when `call` acquires a resource."""
    chain = attr_chain(call.func)
    last = chain.rsplit(".", 1)[-1]
    if chain in STDLIB_RESOURCES:
        kind, rel = STDLIB_RESOURCES[chain]
        return kind, rel, chain
    if last in ("ThreadPoolExecutor", "ProcessPoolExecutor"):
        kind, rel = STDLIB_RESOURCES[last]
        return kind, rel, last
    ref = graph.resolve_in_module(path, chain, cls=cls)
    if ref is not None and ref.cls is not None:
        if ref.name == "__init__" and ref.cls in PROGRAM_RESOURCES:
            kind, rel = PROGRAM_RESOURCES[ref.cls]
            return kind, rel, ref.cls
        if (ref.cls, ref.name) in FACTORY_METHODS:
            kind, rel = PROGRAM_RESOURCES[ref.cls]
            return kind, rel, f"{ref.cls}.{ref.name}"
    return None


def _is_daemon_thread(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant):
            return bool(kw.value.value)
    return False


class _Scope:
    """Release/escape evidence inside one function."""

    def __init__(self, fn: ast.FunctionDef):
        self.fn = fn
        # var -> set of method names called on it, var -> in-finally?
        self.calls: dict[str, set[str]] = {}
        self.finally_calls: dict[str, set[str]] = {}
        self.escapes: set[str] = set()
        self.with_items: set[int] = set()  # id() of ctx exprs
        finally_nodes: set[int] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Try):
                for s in node.finalbody:
                    finally_nodes.update(id(x) for x in ast.walk(s))
            elif isinstance(node, ast.With):
                for item in node.items:
                    self.with_items.add(id(item.context_expr))
                    # `with closing(v)`-style wrappers count as release
                    if isinstance(item.context_expr, ast.Call):
                        for a in item.context_expr.args:
                            if isinstance(a, ast.Name):
                                self.escapes.add(a.id)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                base = node.func.value
                if isinstance(base, ast.Name):
                    self.calls.setdefault(base.id, set()).add(node.func.attr)
                    if id(node) in finally_nodes:
                        self.finally_calls.setdefault(base.id, set()).add(
                            node.func.attr
                        )
            if isinstance(node, ast.Return) and isinstance(
                node.value, ast.Name
            ):
                self.escapes.add(node.value.id)
            if isinstance(node, ast.Yield) and isinstance(
                node.value, ast.Name
            ):
                self.escapes.add(node.value.id)
        # escapes: stored on self/global/subscript, passed to a call,
        # appended into a container
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(
                node.value, ast.Name
            ):
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        self.escapes.add(node.value.id)
            if isinstance(node, ast.Call):
                for a in list(node.args) + [
                    kw.value for kw in node.keywords
                ]:
                    if isinstance(a, ast.Name):
                        fname = attr_chain(node.func).rsplit(".", 1)[-1]
                        if fname not in RELEASE_NAMES:
                            self.escapes.add(a.id)


class ResourceLifecyclePass:
    name = "resource-lifecycle"

    def run(self, index: ModuleIndex) -> list[Finding]:
        graph = ProgramGraph.for_index(index)
        out: list[Finding] = []
        for mod in graph.index:
            table = graph.tables[mod.path]
            has_atexit = "atexit.register" in mod.source
            mod_releases = self._getattr_releases(mod.tree)
            for cname in table.classes:
                info = graph.class_info(cname, mod.path)
                if info is None:
                    continue
                releases = self._class_release_calls(info)
                for attr, names in mod_releases.items():
                    releases.setdefault(attr, set()).update(names)
                for mname, fn in info.methods.items():
                    out.extend(
                        self._check_fn(
                            graph, mod.path, cname, mname, fn,
                            releases, has_atexit,
                        )
                    )
            for (path, fname), fn in graph.module_funcs.items():
                if path == mod.path:
                    out.extend(
                        self._check_fn(
                            graph, mod.path, None, fname, fn,
                            None, has_atexit,
                        )
                    )
        # nested defs are walked from both their own scope and their
        # enclosing function — dedup identical findings
        uniq, seen = [], set()
        for f in out:
            k = (f.path, f.line, f.message)
            if k not in seen:
                seen.add(k)
                uniq.append(f)
        return uniq

    @staticmethod
    def _getattr_releases(tree: ast.Module) -> dict[str, set[str]]:
        """Module-wide release evidence through `getattr` aliasing —
        the `_telemetry_scope` decorator shape: `t = getattr(self,
        "_telemetry", None)` followed by `t.close(...)` releases the
        attribute from OUTSIDE the class body."""
        out: dict[str, set[str]] = {}
        for fn in [
            n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        ]:
            aliases: dict[str, str] = {}
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and attr_chain(node.value.func) == "getattr"
                    and len(node.value.args) >= 2
                    and isinstance(node.value.args[1], ast.Constant)
                    and isinstance(node.value.args[1].value, str)
                ):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            aliases[t.id] = node.value.args[1].value
            if not aliases:
                continue
            for node in ast.walk(fn):
                if (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in aliases
                ):
                    out.setdefault(
                        aliases[node.func.value.id], set()
                    ).add(node.func.attr)
        return out

    @staticmethod
    def _class_release_calls(info) -> dict[str, set[str]]:
        """attr -> method names called on `self.<attr>` anywhere in the
        class (including calls on items iterated OUT of the attr — the
        tracked-thread-list join pattern)."""
        rel: dict[str, set[str]] = {}
        iter_vars: dict[str, str] = {}  # loop var -> source attr
        for fn in info.methods.values():
            for node in ast.walk(fn):
                if isinstance(node, ast.For) and isinstance(
                    node.target, ast.Name
                ):
                    src = node.iter
                    if isinstance(src, ast.Call):
                        src = (
                            src.func.value
                            if isinstance(src.func, ast.Attribute)
                            else src
                        )
                    attr = _self_attr(src)
                    if attr is not None:
                        iter_vars[node.target.id] = attr
                # tuple-unpack swap: `warm, self._x = self._x, []`
                if isinstance(node, ast.Assign) and isinstance(
                    node.targets[0], ast.Tuple
                ) and isinstance(node.value, ast.Tuple):
                    for t, v in zip(
                        node.targets[0].elts, node.value.elts
                    ):
                        attr = _self_attr(v)
                        if isinstance(t, ast.Name) and attr is not None:
                            iter_vars.setdefault(t.id, attr)
                if isinstance(node, ast.Assign) and isinstance(
                    node.targets[0], ast.Name
                ):
                    attr = _self_attr(node.value)
                    if attr is not None:
                        iter_vars.setdefault(node.targets[0].id, attr)
        for fn in info.methods.values():
            for node in ast.walk(fn):
                if not (
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                ):
                    continue
                base = node.func.value
                attr = _self_attr(base)
                if attr is None and isinstance(base, ast.Name):
                    attr = iter_vars.get(base.id)
                if attr is not None:
                    rel.setdefault(attr, set()).add(node.func.attr)
        return rel

    def _check_fn(
        self, graph, path, cls, fname, fn, class_releases, has_atexit
    ) -> list[Finding]:
        out: list[Finding] = []
        scope = None  # built lazily — most functions acquire nothing
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            got = _classify_ctor(graph, path, cls, node)
            if got is None:
                continue
            kind, rel_names, label = got
            if kind == "thread" and _is_daemon_thread(node):
                continue  # daemon threads are backstops by contract
            if scope is None:
                scope = _Scope(fn)
            if id(node) in scope.with_items:
                continue  # context-managed: release is structural
            owner = self._owner_of(
                fn, node, graph.module_mutables.get(path, set())
            )
            if owner is None:
                # unassigned: Thread(...).start() fire-and-forget
                if kind == "thread":
                    out.append(
                        Finding(
                            rule="resource-lifecycle",
                            path=path, line=node.lineno,
                            severity="warning",
                            message=(
                                "non-daemon thread started without a "
                                "handle relies on interpreter-exit join"
                            ),
                            detail=(
                                "store and join it on the owner's stop "
                                "path, or document the exit-join contract"
                            ),
                        )
                    )
                elif kind not in ("file",):
                    out.append(
                        Finding(
                            rule="resource-lifecycle",
                            path=path, line=node.lineno,
                            severity="error",
                            message=(
                                f"{kind} acquired from {label} is "
                                "discarded without a release handle"
                            ),
                            detail=f"release via {'/'.join(rel_names)}",
                        )
                    )
                continue
            okind, oname = owner
            if okind == "escape":
                continue
            if okind == "self":
                rel = (class_releases or {}).get(oname, set())
                if not rel & set(rel_names):
                    out.append(
                        Finding(
                            rule="resource-lifecycle",
                            path=path, line=node.lineno,
                            severity="error",
                            message=(
                                f"{kind} stored on 'self.{oname}' is "
                                f"never released by {cls}"
                            ),
                            detail=(
                                f"no method of {cls} calls "
                                f"{'/'.join(rel_names)} on it"
                            ),
                        )
                    )
            elif okind == "global":
                if not has_atexit:
                    out.append(
                        Finding(
                            rule="resource-lifecycle",
                            path=path, line=node.lineno,
                            severity="warning",
                            message=(
                                f"process-lifetime {kind} in module "
                                f"global '{oname}' has no atexit "
                                "coverage"
                            ),
                            detail=(
                                "register a teardown hook so workers "
                                "and handles do not outlive the process"
                            ),
                        )
                    )
            else:  # local variable
                calls = scope.calls.get(oname, set())
                fin = scope.finally_calls.get(oname, set())
                released = calls & set(rel_names)
                released_fin = fin & set(rel_names)
                if released_fin:
                    continue
                if oname in scope.escapes:
                    continue  # ownership transferred
                if released:
                    out.append(
                        Finding(
                            rule="resource-lifecycle",
                            path=path, line=node.lineno,
                            severity="warning",
                            message=(
                                f"{kind} '{oname}' is released only on "
                                "the happy path"
                            ),
                            detail=(
                                "move the release into try/finally or "
                                "a context manager — the exception "
                                "path leaks it"
                            ),
                        )
                    )
                elif kind == "thread" and "start" not in calls:
                    continue  # constructed but never started
                else:
                    out.append(
                        Finding(
                            rule="resource-lifecycle",
                            path=path, line=node.lineno,
                            severity="error",
                            message=(
                                f"{kind} '{oname}' acquired from "
                                f"{label} is never released"
                            ),
                            detail=f"release via {'/'.join(rel_names)}",
                        )
                    )
        return out

    def _owner_of(self, fn, call: ast.Call, mutables: set[str]):
        """Where the acquisition's value lands: ("self", attr),
        ("global", name) for module-registry stores, ("local", name),
        ("escape", _) when stored into another object, or None for a
        discarded value. The call counts as the assignment's value even
        when wrapped in a conditional expression."""
        for node in ast.walk(fn):
            value = None
            targets: list[ast.AST] = []
            if isinstance(node, ast.Assign):
                value, targets = node.value, node.targets
            elif isinstance(node, ast.NamedExpr):
                value, targets = node.value, [node.target]
            if value is None or not any(
                sub is call for sub in ast.walk(value)
            ):
                continue
            for t in targets:
                attr = _self_attr(t)
                if attr is not None:
                    return ("self", attr)
            for t in targets:
                if isinstance(t, ast.Subscript) and isinstance(
                    t.value, ast.Name
                ) and t.value.id in mutables:
                    return ("global", t.value.id)
            for t in targets:
                if isinstance(t, (ast.Subscript, ast.Attribute)):
                    # stored into some other object: ownership
                    # transferred to its holder
                    return ("escape", attr_chain(t))
            for t in targets:
                if isinstance(t, ast.Name):
                    return ("local", t.id)
        return None
