"""Build the package's CUDA kernels and load them through ctypes.

Each source in ``realhf_tpu_torch/csrc`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, on
first use, under ``realhf_tpu_torch/csrc/build/``. The library's file
name carries a digest of its source, of every header (``*.cuh``) in
``csrc`` and of the flags, so an edited source or shared header is
rebuilt and a stale library is never loaded. ``build()`` starts one
``nvcc`` per missing library, all at once, and waits for them. A failed
build raises with the compiler's output.

Nothing here runs at import time: the CPU tests import every module on
machines without a CUDA toolkit.
"""

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("flash_fwd", "flash_bwd", "flash_decode", "ring_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: compiler output (ptxas register / shared-memory / spill report) per
#: library built by this process
build_log: Dict[str, str] = {}
#: seconds each library took to build in this process
build_seconds: Dict[str, float] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels cannot be "
            "built on this machine.")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that have no library yet, one ``nvcc``
    each, all started together. Returns the seconds each build took."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        compiler = compiler or nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.monotonic())
    failures = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.monotonic() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a file
    if failures:
        raise RuntimeError("\n".join(failures))
    return {n: build_seconds[n] for n in running}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def check(code: int, kernel: str):
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{kernel} launch failed with cudaError {code}")


def on_device(device):
    """The context a ctypes launch runs in: ``device`` made the current
    CUDA device, since a launch goes to the current device's context
    whatever card its tensors are on (nothing to switch for a device
    without an index)."""
    import torch
    if device.index is None:
        return contextlib.nullcontext()
    return torch.cuda.device(device.index)
