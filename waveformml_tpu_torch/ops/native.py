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

Host code in C++ (``csrc/<name>.cpp``, plain C interface; the graph edge
construction of ``ops/graph.py``) is built the same way by ``g++ -O3 -fopenmp
-shared -fPIC`` (``load_host``) into the same directory. A host build that
fails raises ``KernelError``: nothing falls back to another version
quietly.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Iterable, Sequence, Tuple

import torch

from waveformml_tpu_torch.utils import tracing

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "waveformml_tpu_torch"
SOURCES = ("row_conv", "row_conv_wgrad", "site_head", "site_head_bwd", "waveform_features")
#: libraries that the same calls use one after the other, so that ``load``
#: builds them at once (K1's and K4's: a conv's forward, then its backward)
BUILT_TOGETHER = (("row_conv", "row_conv_wgrad"),)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

GXX_FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17")
#: ctypes types of a host library's arguments and results, by the names
#: ``load_host`` takes (a ``ptr`` is a numpy array's ``ctypes.data``)
_HOST_TYPES = {"i64": ctypes.c_int64, "bool": ctypes.c_bool, "ptr": ctypes.c_void_p,
               "void": None}
#: seconds each host library took to build in this process, by name
HOST_BUILDS: Dict[str, float] = {}

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
        # this process's own files: ranks that build at once never share one
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        log = so.with_name(f"{so.name}.{os.getpid()}.log")
        with open(log, "w") as log_f:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=log_f, stderr=subprocess.STDOUT)
        started.append((name, proc, tmp, so, log))
    reports, failures = {}, []
    for name, proc, tmp, so, log in started:
        proc.wait()
        reports[name] = log.read_text()
        log.unlink()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{reports[name]}")
        else:
            os.replace(tmp, so)
    if failures:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failures))
    return reports


def load(name: str, functions: Dict[str, list]) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed (at once with
    those of its ``BUILT_TOGETHER`` group that are not built).
    ``functions`` maps each launch function to its ``argtypes`` (pointers
    and the stream as ``c_void_p``, sizes as ``c_int``); each returns a
    CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        so = library_path(name)
        if not so.exists():
            build(next((group for group in BUILT_TOGETHER if name in group), (name,)))
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


def host_library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def load_host(name: str, functions: Dict[str, Tuple[str, Sequence[str]]]) -> ctypes.CDLL:
    """The loaded host library ``csrc/<name>.cpp``, built first with g++
    where it is not built yet (to a file of this process, then renamed into
    place, so that processes building it at once never load half a file).
    ``functions`` maps each function to its result and argument types, by
    the names of ``_HOST_TYPES``. Raises ``KernelError`` where g++ is
    missing or the build fails."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    so = host_library_path(name)
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise KernelError(f"g++ not found: cannot build the host library {name}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        with tracing.span("native.host_build") as build:
            proc = subprocess.run([gxx, *GXX_FLAGS, str(CSRC / f"{name}.cpp"), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise KernelError(f"host library {name}: g++ exited {proc.returncode}\n"
                                  f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        HOST_BUILDS[name] = build.seconds
    lib = ctypes.CDLL(str(so))
    for fn_name, (restype, argtypes) in functions.items():
        fn = getattr(lib, fn_name)
        fn.restype = _HOST_TYPES[restype]
        fn.argtypes = [_HOST_TYPES[a] for a in argtypes]
    _LIBS[name] = lib
    return lib
