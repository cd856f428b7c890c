"""Build, binding and launch machinery shared by the port's CUDA kernels.

Each kernel package keeps its source in ``csrc/<name>.cu`` with a plain
C interface. :class:`CudaLibrary` compiles it with ``nvcc`` for
``sm_90a`` into ``build/`` beside the package on the first CUDA launch
of the process (never at import: a machine without ``nvcc`` imports the
wrappers and runs their plain versions), names the library by a hash of
the source so a stale build is never loaded, keeps ptxas's report
beside it, and binds it with ``ctypes``. Every C entry point returns the ``cudaError_t`` of its
launch, and :func:`launch` raises on anything but 0 and counts the
launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# dynamic shared memory one block may use on Hopper
MAX_SMEM_BYTES = 232448

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from their csrc/*.cu sources on first CUDA use")


class CudaLibrary:
    """One ``csrc/*.cu`` source, built once and loaded once per process.

    ``bind`` sets the ``argtypes``/``restype`` of the loaded library's
    entry points (and may check constants against the source).
    """

    def __init__(self, source: Path, bind: Callable[[ctypes.CDLL], None]):
        self.source = source
        self.build_dir = source.parent.parent / "build"
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def build(self) -> Tuple[Path, str]:
        """Compile the source (if it has no build yet); returns the
        library path and the compiler's register/shared-memory report.
        The report is kept beside the library, so a build made earlier
        returns the report it printed then."""
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        lib = self.build_dir / f"lib{self.source.stem}-{digest}.so"
        kept = lib.with_suffix(".ptxas.txt")
        if lib.exists():
            return lib, kept.read_text() if kept.exists() else ""
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        report = proc.stdout + proc.stderr
        # the report before the library: a library never stands without
        tmp_report = kept.with_suffix(f".{os.getpid()}.tmp")
        tmp_report.write_text(report)
        os.replace(tmp_report, kept)
        os.replace(tmp, lib)
        return lib, report

    def get(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path, _ = self.build()
                lib = ctypes.CDLL(str(path))
                self._bind(lib)
                self._lib = lib
            return self._lib


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 ndim: int, device: torch.device,
                 contiguous: bool = True) -> None:
    """Type, rank and device of a kernel operand; with ``contiguous`` the
    whole tensor, else only its last dim, must be dense."""
    check(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    check(t.dim() == ndim, f"{name} must have {ndim} dims, got {t.dim()}")
    check(t.device == device, f"{name} is on {t.device}, expected {device}")
    if contiguous:
        check(t.is_contiguous(), f"{name} must be contiguous")
    else:
        check(t.stride(-1) == 1 or t.shape[-1] == 1,
              f"{name} must be dense in its last dim")


def launch(counters: Dict[str, int], name: str, device: torch.device,
           fn, *args) -> None:
    """Call the C entry point ``fn`` on ``device``'s current stream, raise
    on a launch error and count the launch under ``name``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    counters[name] += 1
