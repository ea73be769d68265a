"""Build and bind the port's CUDA kernels: one helper for every family.

Each kernel family keeps its sources in ``csrc/<name>.cu`` beside its
module. A source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point ``<name>_launch`` at first use, into
``build/`` beside the module (a directory git ignores), and bound with
``ctypes``. A library's file name carries a digest of its source and the
flags, so an edited source is rebuilt and a built one is reused. Nothing
here runs at import time, so the CPU-only tests can import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

build_logs: dict = {}  # kernel name -> nvcc's output of its last build (ptxas use)

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or \
        "/usr/local/cuda"
    return str(pathlib.Path(home) / "bin" / "nvcc")


class Library:
    """The CUDA sources of one kernel family.

    Args:
      here: the family's directory (holds ``csrc/`` and ``build/``).
      argtypes: {kernel name: ctypes argument types of ``<name>_launch``};
        every entry point returns a CUDA error code as an int.
    """

    def __init__(self, here, argtypes: dict):
        self.here = pathlib.Path(here).resolve()
        self.argtypes = argtypes
        self._fns: dict = {}

    @property
    def names(self) -> tuple:
        return tuple(self.argtypes)

    @property
    def build_dir(self) -> pathlib.Path:
        return self.here / "build"

    def target(self, name: str) -> tuple[pathlib.Path, pathlib.Path]:
        """(source, library path) of kernel ``name``."""
        src = self.here / "csrc" / f"{name}.cu"
        digest = hashlib.sha256(src.read_bytes() +
                                " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return src, self.build_dir / f"lib{name}-{digest}.so"

    def fn(self, name: str):
        """The bound ``<name>_launch`` entry point, built on first use."""
        if name not in self._fns:
            lib = ctypes.CDLL(str(build((self, name))[name]))
            fn = getattr(lib, f"{name}_launch")
            fn.argtypes = self.argtypes[name]
            fn.restype = ctypes.c_int
            self._fns[name] = (lib, fn)
        return self._fns[name][1]


def build(*targets: tuple) -> dict:
    """Compile the (library, kernel name) targets whose source and flags
    have not been built yet, one ``nvcc`` process per source, all started
    together. Returns {name: library path}; raises once every process has
    ended if any ``nvcc`` failed."""
    running = {}
    for lib, name in targets:
        src, out = lib.target(name)
        if out.exists():
            continue
        lib.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        running[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        build_logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, out)   # atomic: no process loads a partial file
    if failed:
        raise RuntimeError("nvcc failed on " + ", ".join(
            f"csrc/{n}.cu:\n{build_logs[n]}" for n in failed))
    return {name: lib.target(name)[1] for lib, name in targets}


def build_all(*libs: Library) -> dict:
    """Every kernel of the given families, all ``nvcc`` runs at once."""
    return build(*((lib, n) for lib in libs for n in lib.names))


def launch(lib: Library, name: str, device: torch.device, *args) -> None:
    """Call ``<name>_launch(*args, stream)`` on ``device``'s current stream
    and raise if the launch reported a CUDA error."""
    fn = lib.fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
