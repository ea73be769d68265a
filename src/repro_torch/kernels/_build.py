"""Build and bind the port's CUDA kernels: one helper for every family.

Each kernel family keeps its sources in ``csrc/<name>.cu`` beside its
module. A source is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C entry point ``<name>_launch`` at first use, into
``build/`` beside the module (a directory git ignores), and bound with
``ctypes``. A library's file name carries a digest of its source, of
every file of ``csrc/`` that the source includes (``#include "..."``,
followed through nested includes) and of the flags, so an edited source
or header is rebuilt and a built one is reused. Nothing here runs at
import time, so the CPU-only tests can import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess

import torch

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

build_logs: dict = {}  # kernel name -> nvcc's output of its last build (ptxas use)

P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


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

    def sources(self, name: str) -> list[pathlib.Path]:
        """``csrc/<name>.cu`` and every file beside it that it includes
        with quotes, directly or through another include, each once, in
        the order first reached."""
        todo, seen = [self.here / "csrc" / f"{name}.cu"], []
        while todo:
            path = todo.pop(0)
            if path in seen:
                continue
            seen.append(path)
            near = (path.parent / inc.decode()
                    for inc in _INCLUDE.findall(path.read_bytes()))
            todo += [p.resolve() for p in near if p.is_file()]
        return seen

    def target(self, name: str) -> tuple[pathlib.Path, pathlib.Path]:
        """(source, library path) of kernel ``name``; the path's digest
        covers the source, what it includes and the flags."""
        files = self.sources(name)
        digest = hashlib.sha256(b"".join(f.read_bytes() for f in files) +
                                " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return files[0], self.build_dir / f"lib{name}-{digest}.so"

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
    and raise if the launch reported a CUDA error. The device guard is
    entered only when ``device`` is not the current device, and the stream
    is read as a raw pointer (``torch.cuda.current_stream`` builds a Python
    object a call): both cost the host more than the launch itself."""
    fn = lib.fn(name)
    index = device.index
    if index == torch.cuda.current_device():
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
