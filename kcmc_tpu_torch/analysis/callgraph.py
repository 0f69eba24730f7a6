"""Cross-module program graph for the whole-program concurrency passes
(the port's copy of kcmc_tpu/analysis/callgraph.py).

The per-file passes are deliberately AST-local: each rule reasons about
what a reader of ONE file could verify. The concurrency bugs that take
down a resident serve fleet are exactly the ones that scoping cannot
express — a write in `StreamScheduler` racing a read in `Session`
through the shared plane lock, a pool leaked across a module boundary.
This module relaxes the same-module restriction for the `thread-roots`
/ `race` / `resource-lifecycle` passes ONLY: it builds, from the shared
`ModuleIndex`, the program-wide tables those passes walk —

* **imports** — per-module alias resolution (`from kcmc_tpu_torch.io
  import feeder`, `from kcmc_tpu_torch.serve import StreamScheduler`
  through one `__init__` re-export hop) so dotted call names resolve across files;
* **classes / functions** — program-wide registries, plus
  *unique-method CHA*: `obj.m()` resolves to class C when C is the
  only class in the package defining `m` (ambiguous names resolve
  nowhere — deliberately self-limiting);
* **attribute / local types** — `self.scheduler = StreamScheduler(…)`
  and `pool = DecodePool(…)` give `self.scheduler.submit()` /
  `pool.submit()` precise targets without CHA;
* **locks** — per-class lock inventories (reusing the
  `lock_discipline` ctor grammar) EXTENDED with cross-object aliasing:
  a `threading.Condition(lock)` built on a constructor parameter is
  resolved through every static call site of that constructor, so
  `Session._cond` IS `StreamScheduler._lock` to the race detector —
  the serving plane's one-lock design becomes statically visible.

Everything here is still stdlib-`ast` only, and resolution failures
are silent (an unresolved call contributes no edges): the passes built
on top must stay demonstrable on known-bad fixtures and quiet on code
they cannot see into.
"""

from __future__ import annotations

import ast
import dataclasses
import weakref

from kcmc_tpu_torch.analysis.core import FunctionTable, ModuleIndex

# per-ModuleIndex memo of built graphs (see ProgramGraph.for_index)
_GRAPH_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
from kcmc_tpu_torch.analysis.lock_discipline import (
    CONDITION_CTOR,
    LOCK_CTORS,
    _self_attr,
    attr_chain,
)

THREAD_CTOR = "threading.Thread"
EXECUTOR_CTORS = ("ThreadPoolExecutor", "ProcessPoolExecutor")

# The wildcard lock: identity statically unknown (an ambiguous
# constructor binding). It intersects every lock set, so it can never
# make two accesses "disjointly locked" — unresolved aliasing degrades
# to silence, not to false positives.
WILDCARD_LOCK = "*"

# Method names too generic for unique-method CHA: they are container /
# IO protocol vocabulary, and "exactly one program class defines it"
# is then an accident of the current codebase, not evidence of the
# receiver's type.
CHA_STOPLIST = frozenset(
    {
        "add", "append", "appendleft", "extend", "pop", "popleft",
        "clear", "update", "remove", "discard", "insert", "get", "put",
        "items", "keys", "values", "copy", "join", "wait", "set",
        "read", "write", "open", "close", "flush", "send", "recv",
        "acquire", "release", "start", "stop", "submit", "result",
        "cancel", "done", "run", "name", "format",
    }
)


@dataclasses.dataclass(frozen=True)
class FuncRef:
    """One function in the program: (module path, class or None, name)."""

    path: str
    cls: str | None
    name: str

    def label(self) -> str:
        q = f"{self.cls}.{self.name}" if self.cls else self.name
        return f"{self.path}:{q}"


def _module_to_path(index: ModuleIndex, dotted: str) -> str | None:
    """'kcmc_tpu_torch.io.feeder' -> 'kcmc_tpu_torch/io/feeder.py' (or
    the package __init__) when that file is in the index."""
    base = dotted.replace(".", "/")
    for cand in (f"{base}.py", f"{base}/__init__.py"):
        if index.get(cand) is not None:
            return cand
    return None


class _ClassInfo:
    def __init__(self, path: str, node: ast.ClassDef, table: FunctionTable):
        self.path = path
        self.node = node
        self.methods: dict[str, ast.FunctionDef] = dict(
            table.methods.get(node.name, {})
        )
        self.locks: dict[str, int] = {}  # attr -> def line
        self.alias: dict[str, str] = {}  # attr -> attr (Condition on self lock)
        self.param_locks: dict[str, str] = {}  # attr -> __init__ param name
        self.attr_types: dict[str, str] = {}  # attr -> class name
        self.base_names = [attr_chain(b) for b in node.bases]


class ProgramGraph:
    """Program-wide resolution tables over a ModuleIndex (see module
    docstring). Build once per check run; shared by the concurrency
    and lifecycle passes (`for_index` memoizes per index — the three
    passes run over one shared build, not three)."""

    @classmethod
    def for_index(cls, index: ModuleIndex) -> "ProgramGraph":
        cached = _GRAPH_CACHE.get(index)
        if cached is None:
            cached = _GRAPH_CACHE[index] = cls(index)
        return cached

    def __init__(self, index: ModuleIndex):
        self.index = index
        self.tables: dict[str, FunctionTable] = {}
        self.imports: dict[str, dict[str, tuple]] = {}
        self.classes: dict[str, list[_ClassInfo]] = {}
        self.module_funcs: dict[tuple[str, str], ast.FunctionDef] = {}
        self.module_locks: dict[str, dict[str, int]] = {}  # path -> name -> line
        self.module_mutables: dict[str, set[str]] = {}  # path -> global names
        self.ctor_aliases: dict[str, dict[str, str]] = {}  # path -> alias -> ctor
        for mod in index:
            table = FunctionTable(mod.tree)
            self.tables[mod.path] = table
            self.imports[mod.path] = self._imports_of(mod.tree)
            for cname, cnode in table.classes.items():
                self.classes.setdefault(cname, []).append(
                    _ClassInfo(mod.path, cnode, table)
                )
            class_nodes = set()
            for cnode in table.classes.values():
                class_nodes.update(id(n) for n in ast.walk(cnode))
            for fname, fns in table.functions.items():
                for fn in fns:
                    if id(fn) not in class_nodes:
                        self.module_funcs.setdefault((mod.path, fname), fn)
            self._module_scope(mod)
        # method name -> classes defining it (CHA); unique wins
        self.method_owners: dict[str, list[_ClassInfo]] = {}
        for infos in self.classes.values():
            for info in infos:
                for m in info.methods:
                    self.method_owners.setdefault(m, []).append(info)
        for infos in self.classes.values():
            for info in infos:
                self._class_model(info)
        # Constructor-parameter lock bindings need every class model
        # built first (the binding site names locks of the CALLING
        # class), so they run as a second phase.
        self.param_bindings: dict[tuple[str, str], set[str]] = {}
        self._bind_ctor_locks()

    # -- construction ------------------------------------------------------

    def _imports_of(self, tree: ast.Module) -> dict[str, tuple]:
        out: dict[str, tuple] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    path = _module_to_path(self.index, a.name)
                    if path is not None:
                        out[a.asname or a.name.split(".")[0]] = ("mod", path)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    sub = _module_to_path(
                        self.index, f"{node.module}.{a.name}"
                    )
                    if sub is not None:
                        out[a.asname or a.name] = ("mod", sub)
                        continue
                    path = _module_to_path(self.index, node.module)
                    if path is not None:
                        out[a.asname or a.name] = ("sym", path, a.name)
        return out

    def _module_scope(self, mod) -> None:
        """Module-level locks, ctor aliases (`_REAL_LOCK =
        threading.Lock`), and mutable containers (the shared-state
        surface of module-global registries like the feeder pool map)."""
        locks: dict[str, int] = {}
        mutables: set[str] = set()
        aliases: dict[str, str] = {}
        for node in mod.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            names = [
                t.id for t in node.targets if isinstance(t, ast.Name)
            ]
            if not names:
                continue
            v = node.value
            if isinstance(v, (ast.Attribute, ast.Name)):
                ref = attr_chain(v)
                if ref in LOCK_CTORS or ref == CONDITION_CTOR:
                    for n in names:
                        aliases[n] = ref
                continue
            chain = attr_chain(v.func) if isinstance(v, ast.Call) else ""
            chain = aliases.get(chain, chain)
            if chain in LOCK_CTORS or chain == CONDITION_CTOR:
                for n in names:
                    locks[n] = node.lineno
            elif (
                isinstance(v, (ast.Dict, ast.Set, ast.List))
                or chain.rsplit(".", 1)[-1] in ("dict", "set", "list", "deque")
            ):
                mutables.update(names)
        self.ctor_aliases[mod.path] = aliases
        self.module_locks[mod.path] = locks
        self.module_mutables[mod.path] = mutables

    def _class_model(self, info: _ClassInfo) -> None:
        """Locks, aliases, param-locks, and attribute types of a class."""
        aliases = self.ctor_aliases.get(info.path, {})
        for fn in info.methods.values():
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                v = node.value
                chain = attr_chain(v.func) if isinstance(v, ast.Call) else ""
                chain = aliases.get(chain, chain)
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        continue
                    if chain in LOCK_CTORS:
                        info.locks[attr] = node.lineno
                    elif chain == CONDITION_CTOR:
                        arg = v.args[0] if v.args else None
                        inner = _self_attr(arg) if arg is not None else None
                        if inner is not None:
                            info.alias[attr] = inner
                        elif isinstance(arg, ast.Name):
                            # Condition built on a parameter: identity
                            # resolves through the ctor call sites.
                            info.param_locks[attr] = arg.id
                        else:
                            info.locks[attr] = node.lineno
                    elif isinstance(v, ast.Name) and fn.name == "__init__":
                        # self._x = lock_param — plain storage of a
                        # constructor argument (type via call sites)
                        info.param_locks.setdefault(attr, v.id)
                    elif chain and "." not in chain:
                        owner = self.unique_class(chain)
                        if owner is not None:
                            info.attr_types[attr] = chain
                    elif chain:
                        ref = self.resolve_in_module(info.path, chain)
                        if ref is not None and ref.cls and ref.name == "__init__":
                            info.attr_types[attr] = ref.cls

    def _bind_ctor_locks(self) -> None:
        """Resolve param-aliased locks through every static constructor
        call site: `Session(view, self._lock, …)` from a method of
        `StreamScheduler` binds Session's `lock` parameter to
        `StreamScheduler._lock`. Conflicting bindings degrade to the
        wildcard lock. One program-wide call-site sweep feeds every
        class (re-walking per class is quadratic in repo size)."""
        need = {
            info.node.name
            for infos in self.classes.values()
            for info in infos
            if info.param_locks
        }
        if not need:
            return
        sites: dict[str, list] = {}  # cls -> [(path, call, caller_cls)]
        for mod in self.index:
            table = self.tables[mod.path]
            spans: list[tuple[str | None, ast.AST]] = [
                (cname, cnode) for cname, cnode in table.classes.items()
            ]
            class_ids = {
                id(n)
                for _c, cnode in spans
                for n in ast.walk(cnode)
            }
            spans.append((None, mod.tree))
            for caller_cls, scope in spans:
                for node in ast.walk(scope):
                    if caller_cls is None and id(node) in class_ids:
                        continue
                    if not isinstance(node, ast.Call):
                        continue
                    chain = attr_chain(node.func)
                    if chain.rsplit(".", 1)[-1] not in need:
                        continue
                    ref = self.resolve_in_module(
                        mod.path, chain, cls=caller_cls
                    )
                    if (
                        ref is not None
                        and ref.cls in need
                        and ref.name == "__init__"
                    ):
                        sites.setdefault(ref.cls, []).append(
                            (mod.path, node, caller_cls)
                        )
        for infos in self.classes.values():
            for info in infos:
                if not info.param_locks:
                    continue
                init = info.methods.get("__init__")
                if init is None:
                    continue
                params = [a.arg for a in init.args.args if a.arg != "self"]
                for site_path, call, caller_cls in sites.get(
                    info.node.name, ()
                ):
                    bound = self._match_args(params, call)
                    for attr, pname in info.param_locks.items():
                        expr = bound.get(pname)
                        lid = self._lock_expr_id(
                            site_path, caller_cls, expr
                        ) if expr is not None else None
                        key = (info.node.name, attr)
                        self.param_bindings.setdefault(key, set()).add(
                            lid if lid is not None else WILDCARD_LOCK
                        )

    @staticmethod
    def _match_args(params: list[str], call: ast.Call) -> dict[str, ast.AST]:
        bound: dict[str, ast.AST] = {}
        for i, a in enumerate(call.args):
            if i < len(params):
                bound[params[i]] = a
        for kw in call.keywords:
            if kw.arg:
                bound[kw.arg] = kw.value
        return bound

    def _lock_expr_id(
        self, path: str, cls: str | None, expr: ast.AST
    ) -> str | None:
        """The lock identity of an expression at a call site (`self._l`
        of the calling class, or a module-level lock name)."""
        attr = _self_attr(expr)
        if attr is not None and cls is not None:
            info = self.class_info(cls, path)
            if info is not None and self.is_lock_attr(info, attr):
                return self.lock_id(info, attr)
        if isinstance(expr, ast.Name) and expr.id in self.module_locks.get(
            path, {}
        ):
            return f"{path}:{expr.id}"
        return None

    # -- lookup ------------------------------------------------------------

    def class_info(self, name: str, prefer_path: str | None = None):
        infos = self.classes.get(name)
        if not infos:
            return None
        if prefer_path is not None:
            for i in infos:
                if i.path == prefer_path:
                    return i
        return infos[0]

    def unique_class(self, name: str):
        infos = self.classes.get(name)
        return infos[0] if infos and len(infos) == 1 else None

    def unique_method_owner(self, method: str):
        owners = self.method_owners.get(method)
        return owners[0] if owners and len(owners) == 1 else None

    def function(self, ref: FuncRef) -> ast.FunctionDef | None:
        if ref.cls is not None:
            info = self.class_info(ref.cls, ref.path)
            return info.methods.get(ref.name) if info is not None else None
        return self.module_funcs.get((ref.path, ref.name))

    # -- lock identity -----------------------------------------------------

    def is_lock_attr(self, info: _ClassInfo, attr: str) -> bool:
        seen: set[str] = set()
        while attr in info.alias and attr not in seen:
            seen.add(attr)
            attr = info.alias[attr]
        return (
            attr in info.locks
            or attr in info.param_locks
            or attr in info.alias
        )

    def lock_id(self, info: _ClassInfo, attr: str) -> str:
        """Canonical program-wide lock identity for `self.<attr>` of a
        class: alias chains collapse, constructor-parameter locks
        resolve through their (unique) binding, ambiguity wildcards."""
        seen: set[str] = set()
        while attr in info.alias and attr not in seen:
            seen.add(attr)
            attr = info.alias[attr]
        if attr in info.param_locks:
            bindings = self.param_bindings.get(
                (info.node.name, attr), set()
            )
            concrete = {b for b in bindings if b != WILDCARD_LOCK}
            if len(concrete) == 1 and len(bindings) == 1:
                return next(iter(concrete))
            return WILDCARD_LOCK
        return f"{info.node.name}.{attr}"

    # -- call resolution ---------------------------------------------------

    def resolve_in_module(
        self,
        path: str,
        chain: str,
        cls: str | None = None,
        fn: ast.FunctionDef | None = None,
    ) -> FuncRef | None:
        """Resolve a dotted call name seen in `path` (inside class
        `cls`, inside function `fn` for local-variable types) to a
        program FuncRef, or None. Constructor calls resolve to the
        class's `__init__` (FuncRef.cls set, name "__init__")."""
        if not chain or chain.startswith("?"):
            return None
        head, _, rest = chain.partition(".")
        # self.m() / self.attr.m()
        if head == "self" and cls is not None:
            info = self.class_info(cls, path)
            if info is None or not rest:
                return None
            m, _, tail = rest.partition(".")
            if not tail:
                if m in info.methods:
                    return FuncRef(info.path, cls, m)
                return self._cha(m)
            t = info.attr_types.get(m)
            meth = tail.split(".")[-1]
            if t is not None:
                tinfo = self.class_info(t)
                if tinfo is not None and meth in tinfo.methods:
                    return FuncRef(tinfo.path, t, meth)
                return None
            return self._cha(meth)
        imp = self.imports.get(path, {})
        # bare name: local function, local class ctor, imported symbol
        if not rest:
            if (path, head) in self.module_funcs:
                return FuncRef(path, None, head)
            local_cls = self._ctor_ref(head, path)
            if local_cls is not None:
                return local_cls
            got = imp.get(head)
            if got is not None and got[0] == "sym":
                return self._resolve_symbol(got[1], got[2])
            if fn is not None:
                return None
            return None
        # alias.something
        got = imp.get(head)
        if got is not None:
            m = rest.split(".")[-1]
            if got[0] == "mod":
                if (got[1], rest) in self.module_funcs:
                    return FuncRef(got[1], None, rest)
                ref = self._ctor_ref(rest, got[1])
                if ref is not None:
                    return ref
                return None
            # symbol alias with a trailing attr: ClassName.method or
            # ClassName(...) classmethod-ish — try the class's methods
            sym = self._resolve_symbol(got[1], got[2])
            if sym is not None and sym.cls is not None:
                info = self.class_info(sym.cls, sym.path)
                if info is not None and m in info.methods:
                    return FuncRef(sym.path, sym.cls, m)
            return None
        # ClassName.method on a locally-defined class
        table = self.tables.get(path)
        if table is not None and head in table.classes and rest:
            m = rest.split(".")[-1]
            info = self.class_info(head, path)
            if info is not None and m in info.methods:
                return FuncRef(info.path, head, m)
        # obj.m() — unique-method CHA
        return self._cha(rest.split(".")[-1])

    def _ctor_ref(self, name: str, prefer_path: str) -> FuncRef | None:
        info = self.class_info(name, prefer_path)
        if info is None:
            return None
        if self.unique_class(name) is None and info.path != prefer_path:
            return None
        init = info.methods.get("__init__")
        return FuncRef(info.path, info.node.name, "__init__") if init else None

    def _resolve_symbol(self, path: str, name: str, _depth: int = 0):
        """A symbol imported from `path`: function, class ctor, or a
        one-hop re-export through that module's own imports."""
        if (path, name) in self.module_funcs:
            return FuncRef(path, None, name)
        table = self.tables.get(path)
        if table is not None and name in table.classes:
            return self._ctor_ref(name, path)
        if _depth >= 2:
            return None
        got = self.imports.get(path, {}).get(name)
        if got is not None and got[0] == "sym":
            return self._resolve_symbol(got[1], got[2], _depth + 1)
        return None

    def _cha(self, method: str) -> FuncRef | None:
        if method in CHA_STOPLIST:
            return None
        owner = self.unique_method_owner(method)
        if owner is None:
            return None
        return FuncRef(owner.path, owner.node.name, method)
