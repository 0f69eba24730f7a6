"""Every module of kcmc_bench imports with JAX and the JAX package
blocked, comparing top-level module names whole (the port's name
begins with the JAX package's); the reference's modules import with
the port blocked too. Each case runs in a fresh interpreter (CPU)."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "kcmc_bench"
MODULES = sorted(
    "kcmc_bench." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py")
    if "tests" not in p.parts and p.name not in ("__init__.py", "__main__.py")
    and "metrics" not in p.parts
)
REFERENCE = [m for m in MODULES if m.startswith("kcmc_bench.reference.")] + [
    "kcmc_bench.gen", "kcmc_bench.work"]
METRICS = sorted(p.stem for p in (PKG / "metrics").glob("*.py"))

CHILD = r"""
import importlib, importlib.util, sys
BLOCKED = set(sys.argv[1].split(","))

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.partition(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
for name in sys.argv[2:]:
    if name.startswith("metrics/"):
        path = "kcmc_bench/" + name + ".py"
        spec = importlib.util.spec_from_file_location("m", path)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(name)
tops = {m.partition(".")[0] for m in sys.modules}
assert not tops & BLOCKED, tops & BLOCKED
print("ok")
"""


def child(blocked, names):
    return subprocess.run([sys.executable, "-c", CHILD, ",".join(blocked), *names],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)


def test_kcmc_tpu_is_a_prefix_of_the_port():
    # the reason the check compares whole names: a prefix test would
    # take the port for the JAX package
    assert "kcmc_tpu_torch".startswith("kcmc_tpu")
    assert "kcmc_tpu_torch".partition(".")[0] != "kcmc_tpu"


@pytest.mark.parametrize("name", MODULES + ["metrics/" + m for m in METRICS])
def test_imports_without_jax(name):
    r = child(["jax", "jaxlib", "flax", "kcmc_tpu"], [name])
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("name", REFERENCE)
def test_reference_imports_without_the_program(name):
    r = child(["jax", "jaxlib", "flax", "kcmc_tpu", "kcmc_tpu_torch"], [name])
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


def test_blocking_works():
    r = child(["kcmc_tpu"], ["kcmc_tpu"])
    assert r.returncode != 0 and "blocked" in r.stderr
