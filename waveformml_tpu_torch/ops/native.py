"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with
ctypes. No PyTorch headers are included, so a build takes seconds. The
libraries go to ``build/waveformml_tpu_torch/`` at the repository root,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt
and an unchanged one is reused. ``build()`` starts one ``nvcc`` per missing
library, all at once, and waits for all of them.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "waveformml_tpu_torch"
SOURCES = ("row_conv", "row_conv_wgrad", "site_head", "site_head_bwd", "waveform_features")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    # the headers in csrc/ count too: a source may include any of them
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process each, all started together. Returns ``{name: nvcc output}``
    (the ``-Xptxas -v`` register and spill report) for what it built;
    raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = so.with_suffix(".log")
        with open(log, "w") as log_f:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log_f, stderr=subprocess.STDOUT)
        started.append((name, proc, tmp, so, log))
    reports, failures = {}, []
    for name, proc, tmp, so, log in started:
        proc.wait()
        reports[name] = log.read_text()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{reports[name]}")
        else:
            os.replace(tmp, so)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return reports


def load(name: str, functions: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed. ``functions``
    maps each launch function to its ``argtypes`` (pointers and the stream
    as ``c_void_p``, sizes as ``c_int``); each returns a CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            build([name])
        lib = ctypes.CDLL(str(so))
        lib.wf_cuda_error_string.argtypes = [ctypes.c_int]
        lib.wf_cuda_error_string.restype = ctypes.c_char_p
        for fn_name, argtypes in functions.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check_launch(lib: ctypes.CDLL, err: int, kernel: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.wf_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def count_launches(fn: Callable, grids: int) -> None:
    """Count ``grids`` launches of a kernel wrapper ``fn``: in
    ``fn.launches`` where they run now, in ``fn.captured`` where the current
    stream is capturing a CUDA graph (they run only when the graph replays,
    and whoever replays it counts them)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += grids
    else:
        fn.launches += grids
