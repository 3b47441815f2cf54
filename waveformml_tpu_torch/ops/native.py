"""Build and load the port's CUDA C++ kernels.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with
ctypes. No PyTorch headers are included, so a build takes seconds. The
libraries go to ``build/waveformml_tpu_torch/`` at the repository root,
named by a hash of the source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header is rebuilt
and an unchanged one is reused. ``build()`` starts one ``nvcc`` per missing
library, all at once, and waits for all of them.

Each kernel is a ``torch.library`` custom op in the ``waveformml``
namespace (``define_op``): its CUDA kernel launches the hand-written kernel
through ctypes, its CPU kernel is the plain PyTorch version and its fake
kernel gives the output shapes, dtypes and strides, so that the dispatcher
picks the device and ``torch.export`` traces a forward that calls a kernel
as one node of its graph. They are registered through the dispatcher's
own API (``torch.library.Library``) rather than ``torch.library.custom_op``,
whose Python autograd and aliasing wrappers add tens of µs of host time to
every call (``chip_smoke.py``'s dispatch timing, PERF.md §6).
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

#: the ``torch.library`` namespace of the port's kernels
NAMESPACE = "waveformml"

_LIBS: Dict[str, ctypes.CDLL] = {}


class KernelError(RuntimeError):
    """A kernel that could not be built (no ``nvcc``, a failed compile) or
    whose launch returned a CUDA error."""


#: the library that holds the ops' definitions and kernels; it lives as
#: long as the process (a collected library unregisters them)
_LIBRARY = None


def define_op(name: str, schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define the custom op ``waveformml::<name><schema>`` (it mutates none
    of its arguments) with ``cpu`` as its CPU kernel, ``cuda`` as its CUDA
    kernel and ``fake`` as its fake (and meta) kernel; returns the op.
    Raises ImportError where torch has no ``torch.library.register_fake``
    (before 2.4): the kernels have no other way in."""
    global _LIBRARY
    if not hasattr(torch.library, "register_fake"):
        raise ImportError(f"the port's kernels are torch.library custom ops, which need "
                          f"torch >= 2.4 (this is torch {torch.__version__})")
    if _LIBRARY is None:
        _LIBRARY = torch.library.Library(NAMESPACE, "DEF")
    _LIBRARY.define(name + schema)
    _LIBRARY.impl(name, cpu, "CPU")
    _LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIBRARY)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
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
    raises ``KernelError`` with the compiler's output if any build fails."""
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
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failures))
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
    """Raise ``KernelError`` if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.wf_cuda_error_string(err).decode()
        raise KernelError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def count_launches(fn: Callable, grids: int) -> None:
    """Count ``grids`` launches of a kernel wrapper ``fn``: in
    ``fn.launches`` where they run now, in ``fn.captured`` where the current
    stream is capturing a CUDA graph (they run only when the graph replays,
    and whoever replays it counts them)."""
    if torch.cuda.is_current_stream_capturing():
        fn.captured += grids
    else:
        fn.launches += grids
