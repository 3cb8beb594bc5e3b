"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each source ``src/repro_torch/csrc/<name>.cu`` exports a plain C launch
function and is compiled for Hopper (``sm_90a``) into
``build/lib<name>-<hash>.so`` at the repository root (the hash of the
source names the library, so an edited source builds anew), with the
ptxas report (registers, spills) beside it in ``.ptxas.txt``.  Nothing is
built when a module is imported: ``load`` builds on first use, and
``build_all`` starts one ``nvcc`` per source, all at once.
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
BUILD = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("clock_update", "msc_score", "tier_compact", "flash_attention",
           "paged_attention", "rwkv6_scan", "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def ptxas_path(lib: Path) -> Path:
    """Where the ptxas report of library file ``lib`` is kept."""
    return lib.with_suffix(".ptxas.txt")


def build_all(names=SOURCES) -> dict:
    """Compile every missing library in parallel.  Returns, per source,
    the ptxas report (registers, shared memory, spills) and the wall
    seconds of its build; raises if any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.time()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    report = {}
    errors = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        report[name] = {"seconds": time.time() - t0, "ptxas": log.strip()}
        if p.returncode != 0:
            errors.append(f"{name}: nvcc exited {p.returncode}\n{log}")
        else:
            ptxas_path(out).write_text(log)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
