"""Build and bind the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ``ctypes`` (no PyTorch
headers: a build takes seconds). Sources that share kernels include them
from a ``csrc/*.cuh`` header and hold only their own entry points, so that
one big template file does not serialise the build. Libraries land in
``_build/`` beside this package, named by a hash of the source, the
headers it includes (and those they include) and the flags, so an edited
source rebuilds and an unchanged one loads from disk. ``build_all``
starts one ``nvcc`` per source, all at once.

Nothing is built or loaded at import time: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-lineinfo", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
BUILD_SECONDS: Dict[str, float] = {}  # each source's nvcc wall time, in this process
KERNEL_SOURCES = ("ternary_matmul", "flash_decode", "flash_decode_paged", "flash_decode_ring",
                  "flash_decode_fp8", "flash_decode_paged_fp8", "flash_prefill",
                  "flash_prefill_swa", "flash_prefill_fp8",
                  "flash_latent", "lora", "rms_norm")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _headers(text: bytes, seen: set) -> set:
    """The csrc headers ``text`` includes, and those they include."""
    for h in re.findall(rb'#include\s+"([^"]+)"', text):
        if h not in seen:
            seen.add(h)
            _headers((CSRC_DIR / h.decode()).read_bytes(), seen)
    return seen


def _lib_path(name: str) -> Path:
    # the headers the source includes from csrc/ (at any depth) are part of
    # what it builds from
    text = (CSRC_DIR / f"{name}.cu").read_bytes()
    headers = sorted(_headers(text, set()))
    src = text + b"".join((CSRC_DIR / h.decode()).read_bytes() for h in headers)
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def log_path(name: str) -> Path:
    """The compiler's output (ptxas register and shared-memory report)."""
    return BUILD_DIR / f"{name}.log"


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, in parallel.
    Returns name -> library path; raises with the compiler log on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {name: _lib_path(name) for name in names}
    procs: List[tuple] = []
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(log_path(name), "w")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, lib, tmp, log,
                      subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed, t0, pending = [], time.perf_counter(), list(procs)
    while pending:  # poll, so each source's build time is its own
        for item in [p for p in pending if p[4].poll() is not None]:
            name, lib, tmp, log, proc = item
            pending.remove(item)
            log.close()
            BUILD_SECONDS[name] = time.perf_counter() - t0
            if proc.returncode == 0:
                os.replace(tmp, lib)
            else:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n"
                              f"{log_path(name).read_text()}")
        time.sleep(0.05)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


class CudaKernel:
    """One C entry point of one kernel library, with its launch count.

    ``launch`` calls the entry point (which launches on the given stream
    and returns ``cudaGetLastError()``), raises on a nonzero code, and
    only then adds one to ``launches``."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    def _bind(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build_all([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.error_string.argtypes = [ctypes.c_int]
            lib.error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._bind()(*args)
        if rc != 0:
            msg = self._lib.error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
