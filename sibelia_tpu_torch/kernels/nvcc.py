"""Build the port's CUDA kernels with nvcc at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>.so`` (gitignored), rebuilt when the source is
newer.  ``build_all`` starts one nvcc per stale source, all at once, and
waits for them together; ``load`` builds one library if needed and opens
it with ctypes.  A failed build raises.  Every build asks ptxas for each
kernel's registers, shared memory and spills (``-Xptxas -v``); ``BUILD_LOG``
keeps what the compiler said.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "build")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
# the exact aligner's thread pool (-p > 1) can reach a first load from
# several threads at once
_LOAD_LOCK = threading.Lock()
# name -> the compiler's output of the build this process made, if any
BUILD_LOG: dict[str, str] = {}


def source(name: str) -> str:
    return os.path.join(_DIR, "csrc", f"{name}.cu")


def _library(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    so = _library(name)
    return (not os.path.exists(so)
            or os.path.getmtime(so) < os.path.getmtime(source(name)))


def build_all(names: list[str]) -> dict[str, float]:
    """Compile every stale library of `names` in parallel; returns, per
    name, the seconds from the start until its nvcc was collected (the
    builds are collected in order, so an entry can include the wait for
    an earlier one), 0.0 where the library was up to date."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    os.makedirs(BUILD_DIR, exist_ok=True)
    started = {}
    for name in names:
        if _stale(name):
            tmp = f"{_library(name)}.{os.getpid()}.tmp"
            proc = subprocess.Popen(
                [nvcc, *FLAGS, "-o", tmp, source(name)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            started[name] = (proc, tmp, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, t0) in started.items():
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOG[name] = err
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source(name)}:\n{err}")
        else:
            os.replace(tmp, _library(name))
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built if missing or stale."""
    with _LOAD_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = _LIBS[name] = ctypes.CDLL(_library(name))
        return lib
