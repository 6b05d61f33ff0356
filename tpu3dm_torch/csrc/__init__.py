"""Hand-written Hopper kernels, built with nvcc, and the host C++ library,
both bound with ctypes.

Each ``*.cu`` file in this directory compiles into one shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a -shared``).
Every C entry point takes raw device pointers, sizes and a CUDA stream,
launches on that stream, allocates nothing, and returns ``cudaGetLastError()``.
``host.cpp`` (the ASCII PLY parser, the KD partition and the voxel grid)
compiles with the host C++ compiler (``$CXX``, else ``c++``) and the JAX
package's native-tier flags, so its results equal that tier's.

Libraries are built on first use into ``build/`` beside the sources, under a
name that hashes the source, the shared ``*.cuh`` headers and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  ``build()``
compiles several sources at once, one compiler process each; a failed build
raises.  Importing this module builds nothing and needs neither a compiler
nor a GPU.  One lock serialises every build and every first load, so
threads that reach a library at once (the loader's thread pools, the
stream's producer and consumer) build it once and load it once.

A :class:`Kernel` is one C entry point.  Its ``launches`` counter goes up by
one each time a wrapper launches it, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent
BUILD_DIR = SRC_DIR / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The JAX package's native Makefile flags (native/Makefile), with -shared.
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-pthread", "-shared")
HOST_SOURCE = "host.cpp"

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float

# name -> Kernel, in definition order.
KERNELS: dict[str, Kernel] = {}
# Held around build() and every first load; reentrant, since a load builds.
_BUILD_LOCK = threading.RLock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "c++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found: set CXX")
    return found


def _flags(source: str) -> tuple[str, ...]:
    return HOST_FLAGS if source.endswith(".cpp") else NVCC_FLAGS


def library_path(source: str) -> Path:
    """Where the library of ``source`` (a file name in this directory) goes.
    The name hashes the shared headers too, so editing one rebuilds."""
    h = hashlib.sha256()
    for path in [SRC_DIR / source, *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(path.read_bytes())
    h.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources=None) -> dict[str, str]:
    """Compile every source that has no current library, all at once.

    ``sources`` defaults to every ``*.cu`` and ``*.cpp`` here.  Returns the
    compiler's report (for the kernels: ptxas registers, shared memory,
    spills) for each source built now; raises RuntimeError with the
    compiler's output if any build fails.
    """
    if sources is None:
        sources = sorted(p.name for p in [*SRC_DIR.glob("*.cu"), *SRC_DIR.glob("*.cpp")])
    with _BUILD_LOCK:
        return _build(sources)


def _build(sources) -> dict[str, str]:
    todo = [(src, library_path(src)) for src in sources]
    todo = [(src, out) for src, out in todo if not out.exists()]
    if not todo:
        return {}
    compilers = {src: (_cxx() if src.endswith(".cpp") else _nvcc()) for src, _ in todo}
    jobs = []
    for src, out in todo:
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [compilers[src], *_flags(src), "-o", str(tmp), str(SRC_DIR / src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, out, tmp, proc))
    reports, failures = {}, []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{compilers[src]} failed for {src} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
        reports[src] = log
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


class Kernel:
    """One C entry point of a csrc library, with its launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [PTR]  # the stream comes last
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _load(self):
        with _BUILD_LOCK:
            if self._fn is None:
                path = library_path(self.source)
                if not path.exists():
                    build([self.source])
                fn = getattr(ctypes.CDLL(str(path)), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = INT
                self._fn = fn
            return self._fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise if CUDA refuses it.

        The entry points launch on the current CUDA device, so ``device`` is
        made current first where it is not; where it is, the call skips
        ``torch.cuda.device``, whose host time a small kernel would feel."""
        fn = self._fn or self._load()
        stream = torch.cuda.current_stream(device).cuda_stream
        if device.index is None or device.index == torch.cuda.current_device():
            rc = fn(*args, stream)
        else:
            with torch.cuda.device(device):
                rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


_host_lib: ctypes.CDLL | None = None


def host_library() -> ctypes.CDLL:
    """The host C++ library (``host.cpp``), built and loaded at first use."""
    global _host_lib
    with _BUILD_LOCK:
        if _host_lib is None:
            path = library_path(HOST_SOURCE)
            if not path.exists():
                build([HOST_SOURCE])
            lib = ctypes.CDLL(str(path))
            f64 = ctypes.POINTER(ctypes.c_double)
            lib.t3n_parse_floats.restype = ctypes.c_long
            lib.t3n_parse_floats.argtypes = [ctypes.c_char_p, ctypes.c_long, f64, ctypes.c_long]
            lib.t3n_voxel_downsample.restype = ctypes.c_long
            lib.t3n_voxel_downsample.argtypes = [f64, ctypes.c_long, ctypes.c_double, f64,
                                                 ctypes.c_long]
            lib.t3n_kd_perm.restype = None
            lib.t3n_kd_perm.argtypes = [f64, ctypes.c_long, ctypes.c_long,
                                        ctypes.POINTER(ctypes.c_long)]
            _host_lib = lib
        return _host_lib


# Pair lanes per launch: the kernels put the lane on the grid's y axis.
MAX_LANES = 65535


def dispatch(where: str, *tensors: torch.Tensor | None) -> str:
    """"cpu" when every tensor lies on the CPU (the wrapper then runs its
    plain version), "cuda" when every tensor lies on CUDA (it launches its
    kernel); anything else raises."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds in ({"cpu"}, {"cuda"}):
        return kinds.pop()
    raise ValueError(f"{where}: tensors must all lie on the CPU or all on CUDA, got {kinds}")


def check_cuda_tensors(where: str, n_lanes: int, **tensors: torch.Tensor) -> torch.device:
    """Common device / layout checks before a kernel launch.

    Every tensor must be a contiguous CUDA tensor on one device, 16-byte
    aligned (the kernels read float4), and the batch at most MAX_LANES
    lanes.  Returns that device.
    """
    if n_lanes > MAX_LANES:
        raise ValueError(f"{where}: at most {MAX_LANES} lanes per call, got {n_lanes}")
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{where}: tensors on several devices {devices}")
    (device,) = devices
    if device.type != "cuda":
        raise ValueError(f"{where}: expected CUDA tensors, got {device}")
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{where}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{where}: {name} must be 16-byte aligned")
    return device


def check_dtype(where: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{where}: {name} must be {dtype}, got {t.dtype}")
