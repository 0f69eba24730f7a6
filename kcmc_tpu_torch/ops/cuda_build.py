"""Build, load and count the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` into its own shared library
with a plain C interface and loaded with `ctypes`. Libraries live in
`build/kcmc_tpu_torch/` at the root of the checkout, named by a hash of
the source and the flags, so a changed source rebuilds and an unchanged
one loads at once. `build()` starts one `nvcc` per missing library, all
together. Nothing here runs when the package is imported: a kernel is
built at its first launch (or by an explicit `build()`).

`LAUNCHES` counts kernel launches, one per successful wrapper launch;
the plain-version route never touches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kcmc_tpu_torch"
SOURCES = {
    "detect": "detect.cu", "patch": "patch.cu", "warp": "warp.cu",
    "moments": "moments.cu", "select": "select.cu",
    "warp_matrix": "warp_matrix.cu", "warp_field": "warp_field.cu",
    "detect3d": "detect3d.cu", "patch3d": "patch3d.cu",
    "patches": "patches.cu",
}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: dict[str, int] = {
    "detect_response": 0, "extract_blended": 0, "warp_translation": 0,
    "moment_maps": 0, "binned_select_rows": 0, "extract_blended_moments": 0,
    "warp_batch_matrix": 0, "warp_batch_field": 0, "response_fields_3d": 0,
    "extract_blended_3d": 0, "extract_patches": 0,
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_INFO: dict[str, dict] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA "
            "kernels are built from source at first use"
        )
    return path


def target(name: str) -> Path:
    """Path of the built library for `name`, named by a hash of its
    source, the shared headers and the flags."""
    # the shared headers are part of every library's hash
    src = (CSRC / SOURCES[name]).read_bytes() + b"".join(
        p.read_bytes() for p in sorted(CSRC.glob("*.cuh"))
    )
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names=None) -> dict[str, dict]:
    """Compile the named libraries (default: all) that are not built
    yet, one `nvcc` process each, started together. Returns, per name,
    {"seconds", "cached", "ptxas": [register, shared-memory, spill,
    warning and performance-note lines]}; raises with the compiler
    output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = target(name)
        if out.exists():
            BUILD_INFO.setdefault(
                name, {"seconds": 0.0, "cached": True, "ptxas": []}
            )
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out,
        )
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name} (exit {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {
            "seconds": time.perf_counter() - t0,
            "cached": False,
            "ptxas": [
                ln.strip() for ln in log.splitlines()
                if any(w in ln.lower() for w in (
                    "registers", "compiling entry", "spill", "warning", "performance"))
            ],
        }
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {n: BUILD_INFO[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        out = target(name)
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise for a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
