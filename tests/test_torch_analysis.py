"""The port's analysis engine (kcmc_tpu_torch/analysis: `python -m
kcmc_tpu_torch check`) held against the JAX package's
(kcmc_tpu/analysis) on the small-source cases of the reference's
tests/test_analysis.py, plus the port's own contracts:

* pass by pass: each case's sources, with `kcmc_tpu/` paths and
  imports mapped to `kcmc_tpu_torch/`, go through the reference pass
  and the port pass via `ModuleIndex.from_sources`; the findings must
  be equal (rule, mapped path, line, severity, message and detail with
  the package name mapped). The baseline mechanics and the SARIF log
  are held the same way;
* the daemon rule, which the port reads for CUDA work (`daemon-cuda`
  where the reference has `daemon-xla`), on cases of its own;
* the whole port: one cold check of a copy of the package (its cache
  in tmp_path, which the later cases replay): no new error, no stale
  or unjustified baseline entry, `check --json` exit 0, the SARIF log,
  the baseline write/prune round trip, the cache, and an injected
  `daemon-cuda` snippet flipping the exit to 1;
* fault F (the config's signature registries and their validator) and
  item 24 (the package's public surface, `crispness`).

The reference's snippets come from its test module (`test_analysis`)
where they are module-level, and are copied where they are inline.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import test_analysis as ref_cases

from kcmc_tpu.analysis import concurrency as j_conc
from kcmc_tpu.analysis import config_registry as j_cfg
from kcmc_tpu.analysis import core as j_core
from kcmc_tpu.analysis import lifecycle as j_life
from kcmc_tpu.analysis import lock_discipline as j_lock
from kcmc_tpu.analysis import sarif as j_sarif
from kcmc_tpu.analysis import span_registry as j_span
from kcmc_tpu_torch.analysis import concurrency as t_conc
from kcmc_tpu_torch.analysis import config_registry as t_cfg
from kcmc_tpu_torch.analysis import core as t_core
from kcmc_tpu_torch.analysis import lifecycle as t_life
from kcmc_tpu_torch.analysis import lock_discipline as t_lock
from kcmc_tpu_torch.analysis import sarif as t_sarif
from kcmc_tpu_torch.analysis import span_registry as t_span

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = re.compile(r"\bkcmc_tpu\b(?!_torch)")


def port_text(s: str) -> str:
    """The reference package's name mapped to the port's (paths,
    dotted imports, messages)."""
    return _PKG.sub("kcmc_tpu_torch", s)


@pytest.fixture(autouse=True)
def _reset_port_cli_logging():
    """`main` routes the port's advisories through its logger with a
    handler on the captured stderr; undo it after every test, so later
    files see advisories as warnings again."""
    yield
    from kcmc_tpu_torch.obs import log as tlog

    if tlog.cli_logging_active():
        tlog.reset_cli_logging()


# pass name -> (reference pass class, port pass class)
PASSES = {
    "config": (j_cfg.ConfigRegistryPass, t_cfg.ConfigRegistryPass),
    "lock": (j_lock.LockDisciplinePass, t_lock.LockDisciplinePass),
    "race": (j_conc.RacePass, t_conc.RacePass),
    "roots": (j_conc.ThreadRootsPass, t_conc.ThreadRootsPass),
    "life": (j_life.ResourceLifecyclePass, t_life.ResourceLifecyclePass),
    "span": (j_span.SpanRegistryPass, t_span.SpanRegistryPass),
}


def _config_sources(extra_field="", post_init="_validate_field_classification()",
                    affecting='"model"', docs="`model` `batch_size` `mystery`"):
    src = ref_cases.CONFIG_TMPL.format(
        extra_field=extra_field, post_init=post_init, affecting=affecting
    )
    return {"kcmc_tpu/config.py": src}, {"docs/API.md": docs}


def _race_locked():
    return ref_cases.RACE_BAD.replace(
        "self._n = self._n + 1      # worker write, no lock",
        "with self._lock:\n            self._n = self._n + 1",
    ).replace(
        "self._n = 0                # client write, no lock",
        "with self._lock:\n            self._n = 0",
    )


def _race_cross_module_bad():
    bad = dict(ref_cases.RACE_CROSS_MODULE)
    bad["kcmc_tpu/serve/stream.py"] = bad["kcmc_tpu/serve/stream.py"].replace(
        "self.done = self.done + n",
        "self.done = self.done + n\n        self.queued = self.queued - n",
    )
    return bad


_ROOTS_BAD = """
import threading

def work():
    pass

def spawn():
    threading.Thread(target=work, daemon=True).start()
    threading.Thread(target=lambda: None, name="x", daemon=True).start()
"""

_ROOTS_OK = """
import threading

def work():
    pass

def spawn():
    t = threading.Thread(target=work, name="kcmc-w", daemon=True)
    t.start()
    t.join()
"""

_LIFE_LEAK = """
import threading
from concurrent.futures import ThreadPoolExecutor

def leak_thread():
    t = threading.Thread(target=print, name="t", daemon=False)
    t.start()

def leak_pool():
    ex = ThreadPoolExecutor(2)
    ex.submit(print)
"""

_LIFE_CLEAN = """
import threading
from concurrent.futures import ThreadPoolExecutor

def joined():
    t = threading.Thread(target=print, name="t", daemon=False)
    t.start()
    try:
        pass
    finally:
        t.join()

def managed():
    with ThreadPoolExecutor(2) as ex:
        ex.submit(print)

def transferred():
    t = threading.Thread(target=print, name="t", daemon=False)
    return t
"""

_LIFE_RISKY = """
from concurrent.futures import ThreadPoolExecutor

def risky():
    ex = ThreadPoolExecutor(2)
    ex.submit(print)
    ex.shutdown()
"""

_LIFE_OWNER = """
from concurrent.futures import ThreadPoolExecutor

class Owner:
    def start(self):
        self._ex = ThreadPoolExecutor(2)
"""

_SPAN_UNION = (
    "A = frozenset({'a_span'})\n"
    "B = frozenset({'b_span'})\n"
    "SPAN_NAMES = A | B\n"
    "TIMING_KEYS = frozenset()\n"
)


def _span_sources(producer=None):
    producer = ref_cases.SPAN_BAD if producer is None else producer
    return {
        "kcmc_tpu/obs/registry.py": ref_cases.REGISTRY_SRC,
        "kcmc_tpu/corrector.py": producer + "\nX = ('good_span',)\n",
    }


# case id -> (pass, sources, docs, whether the reference case expects
# findings, None where it asserts something narrower). The sources are the reference's cases (tests/test_analysis.py
# :76-115 config, :296-312 lock order, :340-473 race, :485-504 thread
# roots, :524-589 lifecycle, :637-661 span registry).
CASES = {
    "config-clean": ("config", *_config_sources(), False),
    "config-unclassified": ("config", *_config_sources(extra_field="mystery: int = 0"), True),
    "config-double": ("config", *_config_sources(affecting='"model", "batch_size"'), True),
    "config-ghost": ("config", *_config_sources(affecting='"model", "removed_field"'), True),
    "config-no-validator": ("config", *_config_sources(post_init="pass"), True),
    "config-undocumented": ("config", *_config_sources(docs="`model` only"), True),
    "config-no-docs": ("config", _config_sources()[0], None, False),
    "lock-cycle": ("lock", {"kcmc_tpu/serve/pool.py": ref_cases.LOCK_CYCLE}, None, True),
    "lock-cycle-via-call": (
        "lock", {"kcmc_tpu/serve/pool.py": ref_cases.LOCK_CYCLE_VIA_CALL}, None, True),
    "lock-consistent": ("lock", {"kcmc_tpu/serve/pool.py": ref_cases.LOCK_CYCLE.replace(
        "with self._b:\n            with self._a:",
        "with self._a:\n            with self._b:")}, None, False),
    "race-bad": ("race", {"kcmc_tpu/io/counter.py": ref_cases.RACE_BAD}, None, True),
    "race-locked": ("race", {"kcmc_tpu/io/counter.py": _race_locked()}, None, False),
    "race-caller-held": (
        "race", {"kcmc_tpu/io/counter.py": ref_cases.CALLER_HELD}, None, False),
    "race-caller-dropped": ("race", {"kcmc_tpu/io/counter.py": ref_cases.CALLER_HELD.replace(
        "with self._lock:\n            self._write()", "self._write()")}, None, True),
    # the reference asserts only that the plane-locked Stream.queued is
    # quiet here (test_analysis.py:449-471)
    "race-cross-module": ("race", dict(ref_cases.RACE_CROSS_MODULE), None, None),
    "race-cross-module-bad": ("race", _race_cross_module_bad(), None, True),
    "race-construction": ("race", {"kcmc_tpu/io/counter.py": ref_cases.RACE_BAD.replace(
        "def reset(self):\n        self._n = 0                # client write, no lock",
        "def reset(self):\n        pass")}, None, False),
    "roots-unnamed-lambda": ("roots", {"kcmc_tpu/io/spawner.py": _ROOTS_BAD}, None, True),
    "roots-named": ("roots", {"kcmc_tpu/io/spawner.py": _ROOTS_OK}, None, False),
    "life-leaks": ("life", {"kcmc_tpu/io/leaky.py": _LIFE_LEAK}, None, True),
    "life-clean": ("life", {"kcmc_tpu/io/clean.py": _LIFE_CLEAN}, None, False),
    "life-happy-path": ("life", {"kcmc_tpu/io/risky.py": _LIFE_RISKY}, None, True),
    "life-self-attr": ("life", {"kcmc_tpu/io/owner.py": _LIFE_OWNER}, None, True),
    "life-self-attr-fixed": ("life", {"kcmc_tpu/io/owner.py": _LIFE_OWNER
                                      + "\n    def close(self):\n        self._ex.shutdown()\n"},
                             None, False),
    "span-bad": ("span", _span_sources(), None, True),
    "span-stale": ("span", {
        "kcmc_tpu/obs/registry.py": ref_cases.REGISTRY_SRC,
        "kcmc_tpu/corrector.py": "def f(timer):\n"
        "    with timer.stall('good_stall'):\n        pass\n",
    }, None, True),
    "span-union": ("span", {
        "kcmc_tpu/obs/registry.py": _SPAN_UNION,
        "kcmc_tpu/x.py": "def f(t):\n    t.instant('a_span'); t.instant('b_span')\n",
    }, None, False),
}


def _both(sources: dict, docs=None):
    """(reference index, port index) of the same case."""
    j_idx = j_core.ModuleIndex.from_sources(sources, docs=docs)
    t_idx = t_core.ModuleIndex.from_sources(
        {port_text(p): port_text(s) for p, s in sources.items()}, docs=docs
    )
    return j_idx, t_idx


def _mapped(findings) -> list[tuple]:
    return sorted(
        (f.rule, port_text(f.path), f.line, f.severity, port_text(f.message),
         port_text(f.detail))
        for f in findings
    )


def _ported(findings) -> list[tuple]:
    return sorted((f.rule, f.path, f.line, f.severity, f.message, f.detail)
                  for f in findings)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pass_findings_equal_the_reference(case):
    name, sources, docs, fires = CASES[case]
    j_cls, t_cls = PASSES[name]
    j_idx, t_idx = _both(sources, docs)
    want = j_cls().run(j_idx)
    got = t_cls().run(t_idx)
    assert _ported(got) == _mapped(want)
    if name == "race":
        want = [f for f in want if f.rule == "race"]
    if fires is None:
        assert not any("Stream.queued" in f.message for f in got), got
    else:
        assert bool(want) == fires, want


def test_config_pass_on_the_port_reads_no_documents(port_index):
    """The port's package index carries no `docs/` (the JAX package's),
    so the documentation half of config-registry stays silent on the
    port, as the reference's does without the document."""
    idx = port_index
    assert idx.docs == {}
    assert idx.get("kcmc_tpu_torch/config.py") is not None
    assert not any(p.startswith("kcmc_tpu/") for p in idx.modules)


# -- the daemon rule, read for CUDA work ------------------------------------

_DAEMON_TMPL = """
import threading

class Warmer:
    def start(self):
        threading.Thread(
            target=self._warm, name="warm", daemon={daemon}
        ).start()

    def _warm(self):
        self._helper()

    def _helper(self):
        {call}
"""

_DAEMON_MODULE_TMPL = """
import threading

def _warm():
    {call}

def spawn():
    threading.Thread(target=_warm, name="warm-mod", daemon=True).start()
"""


def _daemon_hits(pkg, sources, rule):
    """`rule` findings of one package's lock-discipline pass."""
    core, lock = (j_core, j_lock) if pkg == "jax" else (t_core, t_lock)
    idx = core.ModuleIndex.from_sources(sources)
    return [f for f in lock.LockDisciplinePass().run(idx) if f.rule == rule]


@pytest.mark.parametrize("call", ["self.backend.process_batch(x)", "mc.warmup()"])
def test_daemon_rule_shared_names_fire_in_both(call):
    src = _DAEMON_TMPL.format(daemon="True", call=call)
    want = _daemon_hits("jax", {"kcmc_tpu/serve/warm.py": src}, "daemon-xla")
    got = _daemon_hits("torch", {"kcmc_tpu_torch/serve/warm.py": src}, "daemon-cuda")
    assert len(want) == len(got) == 1
    assert got[0].line == want[0].line and got[0].severity == "error"
    chain = call.split("(")[0]
    assert got[0].message == (
        f"daemon thread 'warm' reaches a kernel build or card work via {chain}"
    )
    assert "nvcc build" in got[0].detail


@pytest.mark.parametrize("call", [
    "backend.stage_upload(frames)",
    "cuda_build.load('patch')",
    "cuda_build.build(['detect'])",
    "torch.cuda.synchronize()",
])
def test_daemon_cuda_fires_on_port_only_names(call):
    """Kernel builds and card work the JAX rule cannot name: the staged
    upload, the nvcc build and load, a `torch.cuda.` call; from a
    class's daemon thread and from a module function's."""
    for tmpl, label in ((_DAEMON_TMPL, "warm"), (_DAEMON_MODULE_TMPL, "warm-mod")):
        src = tmpl.format(daemon="True", call=call)
        got = _daemon_hits("torch", {"kcmc_tpu_torch/serve/warm.py": src}, "daemon-cuda")
        assert [f.message for f in got] == [
            f"daemon thread '{label}' reaches a kernel build or card work "
            f"via {call.split('(')[0]}"
        ], got


def test_daemon_cuda_quiet_on_non_daemon_and_generic_names():
    """A non-daemon thread reaching card work is the contract; a daemon
    thread calling a bare `load`/`build` (json, numpy) is not card work;
    the reference's quiet case stays quiet in both."""
    quiet = [
        _DAEMON_TMPL.format(daemon="False", call="self.backend.stage_upload(x)"),
        _DAEMON_TMPL.format(daemon="True", call="json.load(f)"),
        _DAEMON_TMPL.format(daemon="True", call="np.load(p)"),
    ]
    for src in quiet:
        assert _daemon_hits("torch", {"kcmc_tpu_torch/serve/w.py": src}, "daemon-cuda") == []
    assert _daemon_hits("jax", {"kcmc_tpu/serve/warm.py": ref_cases.DAEMON_OK},
                        "daemon-xla") == []
    assert _daemon_hits("torch", {"kcmc_tpu_torch/serve/warm.py": port_text(
        ref_cases.DAEMON_OK)}, "daemon-cuda") == []


# -- baseline mechanics and SARIF against the reference ---------------------


def test_baseline_split_and_problems_equal_the_reference():
    """The reference's baseline cases (tests/test_analysis.py:685-711)
    through both packages' Baseline: the same split, hygiene findings
    and line-blind keys."""
    out = []
    for core in (j_core, t_core):
        f1 = core.Finding("r", "a.py", 3, "error", "msg one")
        f2 = core.Finding("r", "a.py", 9, "error", "msg two")
        bl = core.Baseline([
            core.BaselineEntry("r", "a.py", "msg one", "justified"),
            core.BaselineEntry("r", "a.py", "gone finding", "was fixed"),
            core.BaselineEntry("r", "b.py", "whatever", ""),
        ])
        new, accepted = bl.split([f1, f2])
        moved = core.Finding("r", "a.py", 456, "error", "msg one")
        out.append((
            [f.as_dict() for f in new], [f.as_dict() for f in accepted],
            [f.as_dict() for f in bl.problems()], bl.entries[0].matches(moved),
            bl.as_dict(),
        ))
    assert out[0] == out[1]
    assert out[1][0][0]["message"] == "msg two" and out[1][3] is True


def test_run_passes_exit_semantics_equal_the_reference():
    """A daemon finding blocks (exit 1) until its baseline entry
    accepts it (exit 0), in both packages under each one's rule id
    (the reference's case, :711)."""
    src = _DAEMON_TMPL.format(daemon="True", call="self.backend.process_batch(x)")
    for core, lock, rule, path, match in (
        (j_core, j_lock, "daemon-xla", "kcmc_tpu/serve/warm.py",
         "daemon thread 'warm' reaches jax compile/dispatch"),
        (t_core, t_lock, "daemon-cuda", "kcmc_tpu_torch/serve/warm.py",
         "daemon thread 'warm' reaches a kernel build or card work"),
    ):
        idx = core.ModuleIndex.from_sources({path: src})
        res = core.run_passes(idx, [lock.LockDisciplinePass()])
        assert res.exit_code == 1 and res.summary()["new_errors"] == 1
        bl = core.Baseline([core.BaselineEntry(rule, path, match, "fixture")])
        res2 = core.run_passes(idx, [lock.LockDisciplinePass()], bl)
        assert res2.exit_code == 0 and res2.baselined and not res2.new


def _validate_sarif(payload: dict) -> None:
    """The reference's structural SARIF 2.1.0 walk (its
    `_validate_sarif` without jsonschema)."""
    assert payload["version"] == "2.1.0"
    run = payload["runs"][0]
    assert run["tool"]["driver"]["name"]
    for rule in run["tool"]["driver"]["rules"]:
        assert rule["id"]
    for r in run["results"]:
        assert r["ruleId"] and r["message"]["text"]
        assert r["level"] in ("none", "note", "warning", "error")
        loc = r["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"]
        assert loc["region"]["startLine"] >= 1


def _shape(obj):
    """The key structure of a JSON document (dict keys and the shape of
    each value; a list by its first element)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__


def test_sarif_equals_the_reference_on_a_race():
    """The reference's SARIF case (:912): the race's result is the
    reference's with the path mapped, the log has the reference's
    shape and passes its structural SARIF 2.1.0 walk, and a baselined
    finding annotates nothing."""
    j_idx, t_idx = _both({"kcmc_tpu/io/counter.py": ref_cases.RACE_BAD})
    want = j_sarif.to_sarif(j_core.run_passes(j_idx, [j_conc.RacePass()]))
    got = t_sarif.to_sarif(t_core.run_passes(t_idx, [t_conc.RacePass()]))
    _validate_sarif(got)
    assert _shape(got) == _shape(want)
    # ruleIndex points into each log's own rule table (the port's has
    # no traced-program rules)
    for log in (got, want):
        rules = log["runs"][0]["tool"]["driver"]["rules"]
        for r in log["runs"][0]["results"]:
            assert rules[r.pop("ruleIndex")]["id"] == r["ruleId"]
    assert got["runs"][0]["results"] == json.loads(port_text(json.dumps(
        want["runs"][0]["results"])))
    race = got["runs"][0]["results"][0]
    assert race["ruleId"] == "race" and race["level"] == "error"
    assert race["locations"][0]["physicalLocation"]["artifactLocation"]["uri"] == \
        "kcmc_tpu_torch/io/counter.py"
    rules = {r["id"] for r in got["runs"][0]["tool"]["driver"]["rules"]}
    assert "daemon-cuda" in rules and not rules & {"daemon-xla", "jit-purity", "donation"}
    bl = t_core.Baseline([t_core.BaselineEntry(
        "race", "kcmc_tpu_torch/io/counter.py", "possible data race on 'Counter._n'",
        "fixture")])
    res2 = t_core.run_passes(t_idx, [t_conc.RacePass()], bl)
    assert t_sarif.to_sarif(res2)["runs"][0]["results"] == []


# -- the whole port ---------------------------------------------------------


@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    """A copy of the port's package: the check cache of every case
    below lives in it, never in the repo."""
    root = tmp_path_factory.mktemp("port")
    shutil.copytree(os.path.join(REPO, "kcmc_tpu_torch"), root / "kcmc_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "*.so"))
    return root


@pytest.fixture(scope="module")
def port_index(port_copy):
    return t_core.ModuleIndex.from_package(str(port_copy))


@pytest.fixture(scope="module")
def checked(port_copy):
    """The one whole-port check: cold (the copy has no cache yet),
    against the package's own baseline; later cases replay its cache."""
    from kcmc_tpu_torch.analysis.cli import run_check

    return run_check(str(port_copy))


def test_port_is_clean_against_its_baseline(checked):
    assert checked.new == [], "NEW findings:\n" + "\n".join(f.format() for f in checked.new)
    assert checked.baseline_problems == [], "\n".join(
        f.format() for f in checked.baseline_problems)
    assert checked.exit_code == 0
    assert checked.passes == ["config-registry", "lock-discipline", "span-registry",
                              "thread-roots", "race", "resource-lifecycle"]
    # the baseline's daemon backstop and races are what the reference
    # accepts of the same code
    keys = {(f.rule, f.path) for f in checked.baselined}
    assert ("daemon-cuda", "kcmc_tpu_torch/serve/scheduler.py") in keys
    assert ("race", "kcmc_tpu_torch/obs/latency.py") in keys


def test_baseline_entries_all_have_reasons():
    from kcmc_tpu_torch.analysis.cli import default_baseline_path

    data = json.load(open(default_baseline_path(), encoding="utf-8"))
    assert data["kind"] == "kcmc_check_baseline" and data["entries"]
    for e in data["entries"]:
        assert e["reason"].strip() and "FILL-ME-IN" not in e["reason"], e
        assert e["path"].startswith("kcmc_tpu_torch/"), e


def test_cache_replays_the_cold_run(port_copy, port_index, checked):
    """A second run over the unchanged copy hits the cache for every
    pass (and every module of the module-scoped pass) and finds the
    same."""
    from kcmc_tpu_torch.analysis.cache import CACHE_DIRNAME, CheckCache
    from kcmc_tpu_torch.analysis.cli import default_passes

    assert CACHE_DIRNAME == ".kcmc_torch_check_cache"
    assert (port_copy / CACHE_DIRNAME / "results.json").exists()
    cache = CheckCache(str(port_copy))
    idx = port_index
    res = t_core.run_passes(idx, default_passes(), cache=cache)
    assert cache.misses == 0 and cache.hits == 5 + len(idx.modules)
    assert res.findings == checked.findings


def test_check_json_exit_and_report(port_copy, checked, capsys, tmp_path):
    from kcmc_tpu_torch.__main__ import main
    from kcmc_tpu_torch.obs.report import main as report_main

    assert main(["check", "--root", str(port_copy), "--json"]) == 0
    out = capsys.readouterr().out
    payload = json.loads(out)
    assert payload["kind"] == "kcmc_check" and payload["ok"] is True
    assert payload["new"] == 0 and payload["baselined"] == len(checked.baselined)
    art = tmp_path / "check.json"
    art.write_text(out)
    assert report_main(str(art)) == 0
    rendered = capsys.readouterr().out
    assert rendered.startswith("kcmc check:") and "OK" in rendered


def test_check_sarif_of_the_port(port_copy, capsys, tmp_path):
    from kcmc_tpu_torch.__main__ import main

    out = tmp_path / "check.sarif"
    assert main(["check", "--root", str(port_copy), "--sarif", str(out)]) == 0
    capsys.readouterr()
    payload = json.loads(out.read_text())
    _validate_sarif(payload)
    assert payload["runs"][0]["results"] == []
    assert payload["runs"][0]["tool"]["driver"]["name"] == "kcmc-check"


def test_write_and_prune_baseline_round_trip(port_copy, checked, capsys, tmp_path):
    from kcmc_tpu_torch.__main__ import main

    root = str(port_copy)
    bl = tmp_path / "bl.json"
    # a missing explicit baseline is a usage error
    assert main(["check", "--root", root, "--baseline", str(bl)]) == 2
    bl.write_text(json.dumps({"kind": "kcmc_check_baseline", "entries": []}))
    assert main(["check", "--root", root, "--baseline", str(bl), "--write-baseline"]) == 1
    written = json.loads(bl.read_text())["entries"]
    assert len(written) == len(checked.findings)
    assert all("FILL-ME-IN" in e["reason"] for e in written)
    # justified entries plus one stale entry: prune drops exactly the
    # stale one, keeps every still-firing one, and the gate passes
    for e in written:
        e["reason"] = "justified for the test"
    stale = {"rule": "race", "path": "kcmc_tpu_torch/gone.py",
             "match": "possible data race on 'Gone.x'", "reason": "was fixed long ago"}
    bl.write_text(json.dumps({"kind": "kcmc_check_baseline", "entries": written + [stale]}))
    capsys.readouterr()
    assert main(["check", "--root", root, "--baseline", str(bl), "--prune-baseline"]) == 0
    assert "pruned 1 stale baseline entry" in capsys.readouterr().err
    assert json.loads(bl.read_text())["entries"] == written

def test_check_fails_on_injected_daemon_cuda_snippet(port_copy, capsys, tmp_path):
    """The negative contract (the reference's :776-800): a daemon thread
    reaching card work appended to the port flips `check` to exit 1."""
    from kcmc_tpu_torch.__main__ import main

    root = tmp_path / "repo"
    shutil.copytree(port_copy, root)
    bad = root / "kcmc_tpu_torch" / "serve" / "scheduler.py"
    bad.write_text(bad.read_text() + "\n\n" + _DAEMON_TMPL.format(
        daemon="True", call="self.backend.stage_upload(frames)"))
    capsys.readouterr()
    assert main(["check", "--root", str(root)]) == 1
    out = capsys.readouterr().out
    assert "[daemon-cuda] daemon thread 'warm' reaches a kernel build or card work " \
           "via self.backend.stage_upload" in out


def test_analysis_cli_imports_no_torch():
    code = ("import sys\nsys.modules['jax'] = None\nsys.modules['kcmc_tpu'] = None\n"
            "import kcmc_tpu_torch.analysis.cli\n"
            "print(sorted(m for m in ('torch', 'numpy') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO}, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# -- fault F: the signature registries --------------------------------------


def test_signature_registries_equal_the_reference():
    import kcmc_tpu.config as jc

    import kcmc_tpu_torch.config as tc

    dropped = set(tc.DROPPED_FIELDS)
    assert tc.SIG_NEUTRAL_FIELDS == jc.SIG_NEUTRAL_FIELDS - dropped
    assert tc.SIG_AFFECTING_FIELDS == jc.SIG_AFFECTING_FIELDS - dropped
    names = {f.name for f in dataclasses.fields(tc.CorrectorConfig)}
    assert names == tc.SIG_NEUTRAL_FIELDS | tc.SIG_AFFECTING_FIELDS
    assert (len(names), len(tc.SIG_NEUTRAL_FIELDS), len(tc.SIG_AFFECTING_FIELDS)) == (97, 43, 54)


@pytest.mark.parametrize("fault", ["unclassified", "both", "stale"])
def test_field_classification_faults_raise_the_reference_error(monkeypatch, fault):
    """A field in neither registry, in both, or a registry name that is
    no field raises the reference's TypeError at construction."""
    import kcmc_tpu.config as jc

    import kcmc_tpu_torch.config as tc

    msgs = []
    for mod in (jc, tc):
        neutral, affecting = set(mod.SIG_NEUTRAL_FIELDS), set(mod.SIG_AFFECTING_FIELDS)
        if fault == "unclassified":
            affecting.discard("seed")
        elif fault == "both":
            neutral.add("seed")
        else:
            affecting.add("not_a_field")
        monkeypatch.setattr(mod, "SIG_NEUTRAL_FIELDS", frozenset(neutral))
        monkeypatch.setattr(mod, "SIG_AFFECTING_FIELDS", frozenset(affecting))
        monkeypatch.setattr(mod, "_FIELDS_VALIDATED", False)
        with pytest.raises(TypeError) as e:
            mod.CorrectorConfig()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert {"unclassified": "missing from", "both": "BOTH",
            "stale": "not_a_field"}[fault] in msgs[1]


def test_config_validates_the_classification_at_construction(monkeypatch):
    import kcmc_tpu_torch.config as tc

    calls = []
    real = tc._validate_field_classification
    monkeypatch.setattr(tc, "_validate_field_classification",
                        lambda: calls.append(1) or real())
    tc.CorrectorConfig(model="affine")
    assert calls == [1]


# -- item 24: the package's public surface ----------------------------------

ROOT_NAMES = (
    "MODELS", "TransformModel", "apply_transform", "get_model",
    "smooth_trajectory", "interpolate_failed",
    "FaultPlan", "RetryPolicy", "classify_transient", "RobustnessReport",
    "Tracer", "FrameRecordStream", "Heartbeat", "build_manifest",
    "Session", "StreamScheduler", "ServeServer", "ServeClient",
)


def test_root_names_resolve_in_the_port():
    import kcmc_tpu_torch
    from kcmc_tpu_torch import models, obs, serve
    from kcmc_tpu_torch.utils import faults, metrics, trajectory

    homes = {"models": models, "trajectory": trajectory, "faults": faults,
             "metrics": metrics, "obs": obs, "serve": serve}
    where = dict.fromkeys(ROOT_NAMES[:4], "models")
    where.update(dict.fromkeys(ROOT_NAMES[4:6], "trajectory"))
    where.update(dict.fromkeys(ROOT_NAMES[6:9], "faults"))
    where["RobustnessReport"] = "metrics"
    where.update(dict.fromkeys(ROOT_NAMES[10:14], "obs"))
    where.update(dict.fromkeys(ROOT_NAMES[14:], "serve"))
    for name in ROOT_NAMES:
        assert getattr(kcmc_tpu_torch, name) is getattr(homes[where[name]], name), name
    assert models.__all__ == ["MODELS", "TransformModel", "apply_transform", "get_model"]
    # the backend registry resolves at the root as in the reference;
    # a name neither package exports still raises
    from kcmc_tpu_torch import backends

    for name in ("available_backends", "get_backend", "register_backend"):
        assert getattr(kcmc_tpu_torch, name) is getattr(backends, name), name
    with pytest.raises(AttributeError):
        kcmc_tpu_torch.not_a_root_name  # noqa: B018


def test_root_import_pulls_in_no_torch():
    code = ("import sys\nsys.modules['jax'] = None\nimport kcmc_tpu_torch\n"
            "assert 'torch' not in sys.modules, 'the root imported torch'\n"
            "assert callable(kcmc_tpu_torch.smooth_trajectory)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO}, timeout=60)
    assert out.returncode == 0, out.stderr


def test_crispness_equals_the_reference():
    from kcmc_tpu.utils.metrics import crispness as jcrisp
    from kcmc_tpu_torch.utils import synthetic
    from kcmc_tpu_torch.utils.metrics import crispness as tcrisp

    d2 = synthetic.make_drift_stack(n_frames=6, shape=(64, 64), max_drift=6.0, seed=4).stack
    d3 = synthetic.make_drift_stack_3d(n_frames=3, shape=(8, 32, 32), seed=2).stack
    for s in (d2, d2 * 1000.0, d3, d3[:, :1], (d2 * 40000).astype(np.uint16)):
        assert tcrisp(s) == jcrisp(s) and tcrisp(s) > 0.0
    for bad in (np.zeros((64, 64), np.float32), np.zeros((2, 2, 2, 2, 2), np.float32)):
        with pytest.raises(ValueError, match="stack") as te:
            tcrisp(bad)
        with pytest.raises(ValueError) as je:
            jcrisp(bad)
        assert str(te.value) == str(je.value)
