"""Incremental result cache for `python -m kcmc_tpu_torch check`
(`.kcmc_torch_check_cache/`; the port's copy of
kcmc_tpu/analysis/cache.py, in a directory of its own so the two
packages' checks of one checkout never share entries).

Several passes build whole-program graphs: seconds per run, paid on
every local check even when nothing changed. This cache keys
analysis results by CONTENT HASH so a repeat run replays findings
instead of re-deriving them:

* **module-scoped passes** (`cache_scope = "module"`:
  lock-discipline — each module's findings depend only on that
  module's source) cache per module: an edit re-analyzes the edited
  files only, everything else replays.
* **program-scoped passes** (the default: the ProgramGraph passes,
  config/span registries) cache against a
  fingerprint over EVERY module + doc hash — whole-program analysis
  has whole-program inputs, so the honest unit of reuse is
  all-or-nothing. The common cases (CI re-runs, repeated local checks,
  doc-only edits) hit.

The cache stores raw pass findings, NEVER gate decisions: baseline
splitting happens fresh on every run, so editing `baseline.json` needs
no invalidation. A schema bump (or any change to the pass list)
invalidates everything. `check --no-cache` bypasses; corrupt or
foreign cache files are ignored, never trusted.
"""

from __future__ import annotations

import hashlib
import json
import os

from kcmc_tpu_torch.analysis.core import Finding, ModuleIndex

SCHEMA = 1
CACHE_DIRNAME = ".kcmc_torch_check_cache"


def _sha(text: str) -> str:
    return hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]


def _index_hashes(index: ModuleIndex) -> dict[str, str]:
    out = {m.path: _sha(m.source) for m in index}
    for name, text in sorted(index.docs.items()):
        out[f"doc:{name}"] = _sha(text)
    return out


_ANALYSIS_SRC_SHA: str | None = None


def _analysis_package_sha() -> str:
    """Hash over EVERY source file of the analysis package. Passes
    share infrastructure (core.py's AST helpers, callgraph.py's
    ProgramGraph), so a module-scoped pass's cached findings must go
    stale when any of it changes — hashing only the pass's own module
    would replay results computed with old shared behavior."""
    global _ANALYSIS_SRC_SHA
    if _ANALYSIS_SRC_SHA is None:
        here = os.path.dirname(os.path.abspath(__file__))
        h = hashlib.sha256()
        for fn in sorted(os.listdir(here)):
            if not fn.endswith(".py"):
                continue
            try:
                with open(os.path.join(here, fn), "rb") as f:
                    h.update(fn.encode())
                    h.update(f.read())
            except OSError:
                continue
        _ANALYSIS_SRC_SHA = h.hexdigest()[:16]
    return _ANALYSIS_SRC_SHA


def _pass_version(p) -> str:
    """Version key for a pass's cached results: the analysis package's
    source hash, the pass's class name, and its declared configuration
    (`module_prefixes` — the one constructor knob the scoped passes
    take), so a narrowed instance never replays a default-scope
    instance's findings."""
    config = repr(getattr(p, "module_prefixes", None))
    return _sha(
        _analysis_package_sha() + type(p).__qualname__ + config
    )


def _sub_index(index: ModuleIndex, paths: list[str]) -> ModuleIndex:
    sub = ModuleIndex()
    for path in paths:
        mod = index.get(path)
        if mod is not None:
            sub.modules[path] = mod
    sub.docs = index.docs
    return sub


class CheckCache:
    """Per-repo findings cache under `<root>/.kcmc_torch_check_cache/`."""

    def __init__(self, root: str):
        self.dir = os.path.join(root, CACHE_DIRNAME)
        self.path = os.path.join(self.dir, "results.json")
        self._data: dict | None = None
        self.hits = 0  # module or whole-pass replays this run
        self.misses = 0

    # -- storage ------------------------------------------------------

    def _load_file(self) -> dict:
        if self._data is None:
            try:
                with open(self.path, encoding="utf-8") as f:
                    data = json.load(f)
                if (
                    data.get("kind") == "kcmc_check_cache"
                    and data.get("schema") == SCHEMA
                ):
                    self._data = data
                else:
                    self._data = {}
            except (OSError, ValueError):
                self._data = {}
        return self._data

    def _save_file(self, data: dict) -> None:
        data["kind"] = "kcmc_check_cache"
        data["schema"] = SCHEMA
        os.makedirs(self.dir, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f)
        os.replace(tmp, self.path)
        self._data = data

    # -- the per-pass seam (called by core.run_passes) ----------------

    def findings_for(self, p, index: ModuleIndex) -> list[Finding]:
        hashes = _index_hashes(index)
        version = _pass_version(p)
        if getattr(p, "cache_scope", "program") == "module":
            return self._module_scoped(p, index, hashes, version)
        return self._program_scoped(p, index, hashes, version)

    def _program_scoped(self, p, index, hashes, version) -> list[Finding]:
        fp = _sha(
            json.dumps([version, sorted(hashes.items())], sort_keys=True)
        )
        data = self._load_file()
        entry = data.get("program", {}).get(p.name)
        if entry and entry.get("fingerprint") == fp:
            self.hits += 1
            return [Finding(**f) for f in entry["findings"]]
        self.misses += 1
        findings = p.run(index)
        data.setdefault("program", {})[p.name] = {
            "fingerprint": fp,
            "findings": [f.as_dict() for f in findings],
        }
        self._save_file(data)
        return findings

    def _module_scoped(self, p, index, hashes, version) -> list[Finding]:
        data = self._load_file()
        stored = data.get("module", {}).get(p.name, {})
        if stored.get("version") != version:
            stored = {"version": version, "modules": {}}
        mod_entries = stored.get("modules", {})
        out: list[Finding] = []
        stale: list[str] = []
        for mod in index:
            entry = mod_entries.get(mod.path)
            if entry is not None and entry.get("sha") == hashes[mod.path]:
                self.hits += 1
                out.extend(Finding(**f) for f in entry["findings"])
            else:
                stale.append(mod.path)
        if stale:
            self.misses += len(stale)
            fresh = p.run(_sub_index(index, stale))
            by_path: dict[str, list] = {path: [] for path in stale}
            for f in fresh:
                by_path.setdefault(f.path, []).append(f.as_dict())
            for path in stale:
                mod_entries[path] = {
                    "sha": hashes[path],
                    "findings": by_path.get(path, []),
                }
            out.extend(fresh)
            # drop entries for deleted modules
            live = {m.path for m in index}
            stored["modules"] = {
                k: v for k, v in mod_entries.items() if k in live
            }
            data.setdefault("module", {})[p.name] = stored
            self._save_file(data)
        return out
