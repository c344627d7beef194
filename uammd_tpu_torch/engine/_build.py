"""Build and bind the port's CUDA kernels (nvcc + ctypes).

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers, so
nvcc takes seconds) and is compiled on first use for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

into ``uammd_tpu_torch/_build/`` (git-ignored), keyed by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, with nvcc's output
beside it (``<name>-<hash>.log``: ptxas's registers, shared memory and
spills per kernel, from -Xptxas -v), then loaded with ``ctypes``. No
fast-math: the rebin kernel must round every division, multiply and add
as IEEE float32 does.

Each C entry point takes tensor pointers and the stream as ``void*``,
launches on PyTorch's current stream, does not synchronise, and returns
``cudaGetLastError()``; ``Kernel.__call__`` raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(SRC_DIR.glob("*.cuh")))  # shared headers
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` into a temporary file; None if already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, tmp, out


def _finish(name: str, started) -> str | None:
    """Wait for nvcc; install the library and its log, or return nvcc's log
    on failure."""
    proc, tmp, out = started
    log = proc.communicate()[0].decode(errors="replace")
    if proc.returncode != 0:
        os.unlink(tmp)
        return f"nvcc failed for {name}.cu:\n{log}"
    out.with_suffix(".log").write_text(log)  # first: a library never lacks its log
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return None


def build(names=None) -> float:
    """Compile the named sources (default: every ``csrc/*.cu``), one nvcc
    process per source, all started together, and wait for all of them.
    Returns the wall seconds; raises with nvcc's output if any failed."""
    if names is None:
        names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    t0 = time.perf_counter()
    started = {name: _start(name) for name in names}
    errors = [_finish(name, s) for name, s in started.items() if s is not None]
    errors = [e for e in errors if e]
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output of the build of ``csrc/<name>.cu``, built first if
    needed."""
    build([name])
    return library_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBS[name]


def check_cuda_tensor(t: torch.Tensor, name: str, shape=None, dtype=torch.float32):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def check_cuda_tensors(ts, name: str, shape, dtype=torch.float32):
    """``check_cuda_tensor`` on each of ``ts`` (one shape and dtype), with a
    quick pass first: the full check, and its message, only for a tensor
    that fails it."""
    if type(shape) is not torch.Size:
        shape = torch.Size(shape)
    for k, t in enumerate(ts):
        if not (t.is_cuda and t.dtype is dtype and t.shape == shape and t.is_contiguous()):
            check_cuda_tensor(t, f"{name} {k}", shape, dtype)


class Kernel:
    """One C entry point of ``csrc/<source>.cu`` with its launch count.

    ``launches`` is a plain integer that grows by one per successful launch
    (and nowhere else), so a run can show which kernels its path went
    through; callers may reset it to 0."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(load(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        # the current device's current stream as a raw handle: what
        # torch.cuda.current_stream().cuda_stream gives, without building a
        # Stream object (~8 us of host time a launch on an H100's host,
        # against ~1 us); the device straight from the C binding (CUDA is
        # initialised: the caller holds CUDA tensors)
        stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} failed to launch: CUDA error {err}")
        self.launches += 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
