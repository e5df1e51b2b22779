"""Build and load the hand-written CUDA kernels.

The sources in ``fast_slic_tpu_torch/csrc/*.cu`` are compiled on first use
by one ``nvcc -c`` per source, all started together, and linked into
``build/fast_slic_tpu_torch/libfstt_kernels.so`` (beside the package, in the
checkout), which is loaded with ctypes.  The
sources expose a plain C interface: every pointer and the CUDA stream are
passed as ``c_void_p``, and every entry point returns ``cudaGetLastError()``
so a refused launch raises in the wrapper.

``-fmad=false`` keeps every float multiply and add separately rounded (the
JAX package blocks the same contraction with ``pipeline._nofma``); no
``--use_fast_math``, so division and ``sqrtf`` stay IEEE.
"""

from __future__ import annotations

import ctypes
import functools
import os
import pathlib
import shutil
import subprocess
import time

import torch

from ..utils.timing import COUNTS

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fast_slic_tpu_torch"
LIB_PATH = BUILD_DIR / "libfstt_kernels.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

# C signatures of the entry points (every one returns cudaError_t as int)
_SIGNATURES = {
    "fstt_lab": [P, P, P, P, P, I, P],
    "fstt_assign": [P, P, P, P, P, F, I, I, I, I, I, I, I, I, I, I, I, P],
    "fstt_slic_update": [P, P, P, I, I, I, I, I, I, P],
    "fstt_slic_update_masked": [P, P, P, P, I, I, I, I, I, I, P],
    "fstt_segment_sum": [P, P, P, I, I, I, P],
    "fstt_framed_segment_sum": [P, P, P, I, I, I, I, P],
    "fstt_cc": [P, P, I, I, P],
    "fstt_region_table": [P, P, P, I, P],
    "fstt_seam_min": [P, P, P, P, P, P, I, I, I, P],
    "fstt_propagate_min": [P, P, P, P, I, P],
    "fstt_lookup": [P, P, P, I, I, P],
    "fstt_cca_select": [P, P, LL, P, P, P, I, I, I, I, I, P],
    "fstt_assign_float": [P, P, P, P, P, P, P, F, I, I, I, I, I, I, I, I, I,
                          I, I, I, P],
    "fstt_lsc_feat": [P, P, P, I, P],
    "fstt_fsegsum": [P, P, P, P, P, LL, I, I, I, I, P],
    "fstt_knn_buckets": [P, P, I, I, I, I, I, I, P, P, P],
    "fstt_knn": [P, P, P, P, I, I, I, I, I, P, I, P, P, P],
    "fstt_candidates": [P, P, P, P, I, I, I, I, I, I, P, P, P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of fast_slic_tpu_torch "
                       "are built from source on first use")


def build(force: bool = False) -> float:
    """Compile the kernels if the library is missing or older than a source.
    Returns the seconds spent compiling (0.0 when up to date)."""
    sources = sorted(CSRC.glob("*.cu"))
    newest = max(s.stat().st_mtime for s in sources)
    if (not force and LIB_PATH.exists()
            and LIB_PATH.stat().st_mtime >= newest):
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = "%d" % os.getpid()
    tmp = BUILD_DIR / ("libfstt_kernels.%s.so" % tag)
    objs = [BUILD_DIR / ("%s.%s.o" % (s.stem, tag)) for s in sources]
    t0 = time.perf_counter()
    nvcc = _nvcc()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for s, o in zip(sources, objs)]
    outs = []
    for p in procs:
        out, err = p.communicate()
        outs.append((p.args, p.returncode, out, err))
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, rc, _, _ in outs):
        proc = subprocess.run(link, capture_output=True, text=True)
        outs = [(link, proc.returncode, proc.stdout, proc.stderr)]
    for o in objs:
        o.unlink(missing_ok=True)
    for args, rc, out, err in outs:
        if rc != 0:
            raise RuntimeError("nvcc failed (%d): %s\n%s\n%s" % (
                rc, " ".join(args), out, err))
    os.replace(tmp, LIB_PATH)
    return time.perf_counter() - t0


# entry point name -> its ctypes function, filled once when the library loads
FUNCS: dict = {}


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        FUNCS[name] = fn
    return lib


def stream() -> int:
    """PyTorch's current CUDA stream on the current device, as an int: the
    raw handle that ``torch.cuda.current_stream().cuda_stream`` also gives,
    without building a Stream object, which costs several microseconds a
    call (``scripts/host_cost.py``)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def launch(name: str, device: torch.device, *args, launches: int = 1) -> None:
    """Call one C entry point on ``device`` (the card the wrapper's tensors
    lie on), on PyTorch's current stream there; raise if the launch was
    refused.  The card is made the current one for the call when it is
    not, as the shards of a mesh over several cards need.  Pointers are
    passed as ints (``t.data_ptr()``), which the ``c_void_p`` argtypes
    convert.  ``launches`` (0 where the entry point skips a pass with no
    rows) is added to ``utils.timing.COUNTS["launch." + name]``."""
    fn = FUNCS.get(name)
    if fn is None:
        library()
        fn = FUNCS[name]
    if device.index == torch._C._cuda_getDevice():
        err = fn(*args, stream())
    else:
        with torch.cuda.device(device):
            err = fn(*args, stream())
    if err != 0:
        raise RuntimeError("CUDA kernel %s failed: cudaError %d" % (name, err))
    COUNTS["launch." + name] += launches


def check(t: torch.Tensor, name: str, dtype, device, shape=None):
    """Validate a tensor before its pointer is handed to a kernel: dtype,
    CUDA device and its index, contiguity and (if given) shape."""
    if t.dtype is not dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if not t.is_cuda or t.get_device() != device.index:
        raise ValueError("%s must be on %s, got %s" % (name, device, t.device))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if shape is not None and t.shape != tuple(shape):
        raise ValueError("%s must have shape %s, got %s"
                         % (name, tuple(shape), tuple(t.shape)))
