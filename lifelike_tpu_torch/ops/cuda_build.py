"""Build the port's CUDA kernels: one nvcc per source, into shared libraries.

Each kernel source in csrc/ is compiled with plain nvcc for sm_90a into a
shared library with a C ABI (loaded with ctypes by its wrapper module). A
library is named by a hash of its source, the headers it includes and the
flags, so an edited source is rebuilt; it goes to lifelike_tpu_torch/build/
with the ptxas report (registers, spills) beside it. `build_all` starts the
nvcc of every kernel at once and waits for all of them.
"""
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import NamedTuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class Kernel(NamedTuple):
    source: str  # translation unit in csrc/
    headers: tuple  # csrc/ headers it includes (part of the library's hash)


class BuildInfo(NamedTuple):
    path: str  # the shared library
    seconds: float  # nvcc wall time of this process's build (0.0 if reused)
    ptxas: str  # nvcc/ptxas -v report of the build that made `path`


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return path


def _paths(k: Kernel):
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (k.source,) + tuple(k.headers):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    stem = os.path.join(BUILD_DIR, f"lib{os.path.splitext(k.source)[0]}_{h.hexdigest()[:16]}")
    return stem + ".so", stem + ".ptxas.txt"


def _start(k: Kernel):
    """Start nvcc for `k` unless its library exists; returns the pending
    build (process, temporary path, start time) or None."""
    so, _ = _paths(k)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, k.source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, tmp, time.perf_counter(), cmd


def _finish(k: Kernel, pending) -> BuildInfo:
    so, log = _paths(k)
    seconds = 0.0
    if pending is not None:
        proc, tmp, t0, cmd = pending
        out, err = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}\n{err}")
        # the report, then the library, each moved in whole: a process that
        # finds the library (another rank building the same kernel) finds
        # both complete
        with open(f"{log}.{os.getpid()}.tmp", "w") as f:
            f.write(out + err)
        os.replace(f"{log}.{os.getpid()}.tmp", log)
        os.replace(tmp, so)
    with open(log) as f:
        return BuildInfo(path=so, seconds=seconds, ptxas=f.read())


def build(k: Kernel) -> BuildInfo:
    """Compile `k` if its library is missing; returns where it is."""
    return _finish(k, _start(k))


def build_all(kernels) -> list:
    """One nvcc per kernel, all started together; BuildInfo per kernel."""
    pending = [_start(k) for k in kernels]
    return [_finish(k, p) for k, p in zip(kernels, pending)]


def ptxas_summary(text, kernel_name):
    """{kernel symbol: {registers, spill_stores, spill_loads, stack}} of the
    entry points whose mangled name contains `kernel_name`, from a ptxas -v
    report."""
    out, current = {}, None
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            out.setdefault(current, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and current:
            out[current].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1)
            out.setdefault(current, {})
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current]["registers"] = int(m.group(1))
    return {k: v for k, v in out.items() if kernel_name in k}
