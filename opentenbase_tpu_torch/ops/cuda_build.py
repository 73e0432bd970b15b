"""Build the port's hand-written CUDA kernels (csrc/*.cu) for sm_90a.

Each source compiles with ``nvcc`` into its own shared library with a
plain C interface, named by a digest of the source, in the package's
``build/`` directory (git-ignored): an unchanged source is compiled once.
Several sources compile in parallel, one ``nvcc`` each. Nothing is built
when the module is imported; the kernel wrappers build on their first
launch, and ``chip_smoke.py`` builds every kernel up front.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("scan_agg.cu", "radix_probe.cu")

_mu = threading.Lock()
# source name -> the ptxas report of the build this process ran
ptxas_logs: dict[str, str] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    return "nvcc"


def library_path(source: str) -> str:
    """Where ``csrc/<source>`` builds to: named by its content digest."""
    with open(os.path.join(CSRC, source), "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")


def build(*sources: str) -> dict[str, str]:
    """Compile each of ``sources`` (names under csrc/) that has no library
    yet, all in parallel, and return source -> library path. Raises on
    the first compiler failure, with its output."""
    with _mu:
        os.makedirs(BUILD_DIR, exist_ok=True)
        out = {s: library_path(s) for s in sources}
        procs = []
        for src, lib in out.items():
            if os.path.exists(lib):
                continue
            tmp = f"{lib}.{os.getpid()}.tmp"
            cmd = [
                nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", tmp, os.path.join(CSRC, src),
            ]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        failed = []
        for src, lib, tmp, p in procs:
            log, _ = p.communicate()
            ptxas_logs[src] = log
            if p.returncode != 0:
                failed.append(f"{src}: nvcc exit {p.returncode}\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
        return out


def load(source: str) -> ctypes.CDLL:
    """Build ``csrc/<source>`` if needed and load its library."""
    return ctypes.CDLL(build(source)[source])
