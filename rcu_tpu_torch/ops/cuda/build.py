"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``rcu_tpu_torch/csrc/<name>.cu`` has a plain C interface and compiles
with ``nvcc`` for ``sm_90a`` into ``rcu_tpu_torch/_build/<name>-<hash>/``
(git-ignored), keyed on a hash of the source and the flags, so an edited
source rebuilds and an unchanged one loads the library already built. A
missing ``nvcc`` or a failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of rcu_tpu_torch cannot be built")
    return nvcc


def library_path(name: str) -> str:
    source = os.path.join(SRC_DIR, f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}",
                        f"lib{name}.so")


def _report_path(name: str) -> str:
    return os.path.join(os.path.dirname(library_path(name)), "nvcc.txt")


def report(name: str) -> str:
    """The compiler output (``-Xptxas -v``: registers, shared memory,
    spills) of the library built for the current source."""
    with open(_report_path(name)) as f:
        return f.read()


def build_all(names) -> dict:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns ``{name: compiler output}`` (``-Xptxas -v`` register
    and spill report) for the libraries built by this call."""
    jobs = {}
    for name in names:
        path = library_path(name)
        if os.path.exists(path):
            continue
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(SRC_DIR, f"{name}.cu")]
        jobs[name] = (path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (path, tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        with open(_report_path(name), "w") as f:
            f.write(out)
        os.replace(tmp, path)  # atomic: concurrent builders never see half a file
        reports[name] = out
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built first if needed."""
    build_all([name])
    return ctypes.CDLL(library_path(name))
