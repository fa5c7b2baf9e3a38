"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` into ``build/lib<name>-<hash>.so`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides the directory), then loaded with
``ctypes``.  The file name carries a hash of the source, of every
``csrc/*.cuh`` header it includes and of the flags, so an edited source or
header is rebuilt and an unchanged one is reused.  ``build_all``
starts one ``nvcc`` per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises when that is not 0.  Nothing here runs at import time: the
CPU tests import every module of the port on a machine without ``nvcc``.
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
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("traversal", "fes", "topk", "build", "flash_attention")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC"]

_LIBS: Dict[str, ctypes.CDLL] = {}
# wall seconds of the last build_all, per source it compiled
BUILD_SECONDS: Dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else CSRC.parents[2] / "build"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels build only on a machine with "
                           "the CUDA toolkit")
    return nvcc


def _headers(src: bytes) -> list:
    """The ``csrc/`` headers a source includes (``#include "x.cuh"``)."""
    return sorted(set(re.findall(rb'#include\s+"([\w.]+\.cuh)"', src)))


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha1(src)
    for header in _headers(src):
        h.update((CSRC / header.decode()).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source in parallel;
    returns ``{name: path}``.  Raises with nvcc's output on failure."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: _target(name) for name in names}
    todo = {k: p for k, p in paths.items() if not p.exists()}
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path)
    errors = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
        else:
            tmp.replace(path)
    if errors:
        raise RuntimeError("\n".join(errors))
    if todo:
        BUILD_SECONDS.update({name: time.perf_counter() - t0
                              for name in todo})
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build_all([name])[name]
        lib = ctypes.CDLL(str(path))
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def on_cpu(what: str, *ts) -> bool:
    """True when every operand lies on the CPU (the wrapper then runs its
    plain version), False when all are on one CUDA device; raises on a mix
    or on another device type.  None operands (absent options) are
    skipped."""
    devs = {t.device for t in ts if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{what} operands on several devices: {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {dev}")
    return False


def next_pow2(x: int) -> int:
    return 1 << max(1, (x - 1).bit_length())


def ptr(t) -> ctypes.c_void_p:
    """The device pointer of a tensor, or a null pointer for None."""
    return ctypes.c_void_p(0 if t is None else t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
