"""Build the port's CUDA kernels from the sources in ``ops/csrc`` at
first use, and load them with ``ctypes``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into shared libraries
with a plain C interface (no PyTorch headers, so a build takes seconds,
not minutes): one library per element type the kernels take
(``-DFLASH_DTYPE=<code>``, :data:`LIBRARIES`), all compiled side by side.
Libraries go to ``ray_tpu_torch/_build/`` (listed in ``.gitignore``),
named by a hash of their source, their type and the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and an unchanged one is
reused. A failed build raises; nothing falls back. Each build and load
is counted as a compile-plane event (``util/device_telemetry.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

from ray_tpu_torch.util.device_telemetry import record_compile_event

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

# kernel name -> source file under csrc/
SOURCES = {"flash_attention_fwd": "flash_attention_fwd.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}
# the element types, by their code in the C entry points (the wrapper's
# KERNEL_DTYPES): a library is built for one of them
DTYPE_NAMES = ("bf16", "f16", "f32")
# library name -> (kernel name, type code): "flash_attention_fwd_bf16", ...
LIBRARIES = {f"{name}_{t}": (name, code) for name in SOURCES
             for code, t in enumerate(DTYPE_NAMES)}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the CUDA kernels are built from source at first use")


def library_name(kernel: str, code: int) -> str:
    """The library of kernel ``kernel`` built for type code ``code``."""
    return f"{kernel}_{DTYPE_NAMES[code]}"


def library_path(name: str) -> Path:
    kernel, code = LIBRARIES[name]
    h = hashlib.sha256((CSRC / SOURCES[kernel]).read_bytes())
    h.update(f"FLASH_DTYPE={code}".encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = tuple(LIBRARIES)) -> Dict[str, dict]:
    """Compile every named library (of :data:`LIBRARIES`) that is not
    built yet, one ``nvcc`` each, all started together. Returns ``{name:
    {"path", "seconds", "log"}}`` for the ones compiled here (``log``
    holds ptxas's register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            continue
        kernel, code = LIBRARIES[name]
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-DFLASH_DTYPE={code}", "-o",
               str(tmp), str(CSRC / SOURCES[kernel])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a partial .so
        out.with_suffix(".log").write_text(log)
        report[name] = {"path": str(out), "seconds": seconds, "log": log}
        record_compile_event("kernel.build", seconds)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (of :data:`LIBRARIES`), built first if
    needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        t0 = time.perf_counter()
        lib = ctypes.CDLL(str(library_path(name)))
        record_compile_event("kernel.load", time.perf_counter() - t0)
        _loaded[name] = lib
    return lib
