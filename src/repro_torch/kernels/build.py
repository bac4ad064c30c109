"""Build the port's CUDA C++ kernels with ``nvcc`` and bind them with ctypes.

Each source ``repro_torch/csrc/<name>.cu`` compiles on first use into its own
shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<name>-<hash>.so \\
         csrc/<name>.cu

under the repository's ``build/kernels/`` (git-ignored). The file name
carries a hash of the source and flags, so an edited source never loads a
stale library. Nothing here runs at import time: the CPU tests import every
module of the port on a machine without ``nvcc``.

Every C entry returns the launch's ``cudaError_t``; :func:`check` turns a
nonzero code into an exception.
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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
F = ctypes.c_float

#: C signatures, by source name: ``{entry: argtypes}``; every entry returns
#: an int (the ``cudaError_t`` of its launches).
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "sorted_weight": {
        # x, out, plan (struct SortedWeightPlan), stream
        "sorted_weight": (P, P, P, P),
    },
    "pairdist": {
        # x, out, plan (struct PairdistPlan), stream
        "pairdist": (P, P, P, P),
    },
    "randk": {
        # g, ids, payload, n, d, kb, bs, ids_stride, alpha, dtype, stream
        "block_compress": (P, P, P, I, LL, I, I, I, F, I, P),
        # payload, slots, dense, n, nb, kb, bs, slots_stride, dtype, stream
        "block_decompress": (P, P, P, I, I, I, I, I, I, P),
        # m, payload, slots, out32, n, nb, kb, bs, slots_stride, beta, omb,
        # m_dtype, p_dtype, stream
        "momentum_scatter": (P, P, P, P, I, I, I, I, I, F, F, I, I, P),
    },
    "flash_attention": {
        # q, k, v, o, lse, B, Sq, Sk, H, KV, D, causal, window, q_offset,
        # scale, stream
        "flash_fwd": (P, P, P, P, P, I, I, I, I, I, I, I, I, I, F, P),
        # q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, D,
        # causal, window, q_offset, scale, stream
        "flash_bwd": (P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                      I, F, P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
#: ``{source name: (seconds, nvcc/ptxas report)}`` of the builds this
#: process ran (``-Xptxas -v`` reports registers and spills per kernel).
BUILD_LOG: Dict[str, tuple] = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    raise KernelBuildError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin): the CUDA "
        "kernels build only on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[tuple]:
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    ``(process, tmp_path, out_path, t0)`` or ``None``."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out, time.perf_counter()


def _finish(name: str, job: tuple) -> None:
    proc, tmp, out, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed on {name}.cu:\n{log}")
    os.replace(tmp, out)
    BUILD_LOG[name] = (time.perf_counter() - t0, log)


def build(names: Iterable[str] = tuple(SIGNATURES)) -> None:
    """Compile every named source that has no library yet, all ``nvcc``
    processes started together."""
    names = list(names)
    jobs = {n: _start(n) for n in names}
    errors = []
    for n, job in jobs.items():
        if job is None:
            continue
        try:
            _finish(n, job)
        except KernelBuildError as e:
            errors.append(str(e))
    if errors:
        raise KernelBuildError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The bound library of ``csrc/<name>.cu``, building it on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    for entry, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a ``cudaError_t``)."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


_ENTRIES: Dict[tuple, object] = {}
_SM_COUNTS: Dict[int, int] = {}


def entry(name: str, fn: str):
    """The bound C function ``fn`` of ``csrc/<name>.cu`` (built on first
    use), kept after the first call."""
    f = _ENTRIES.get((name, fn))
    if f is None:
        f = _ENTRIES[(name, fn)] = getattr(load(name), fn)
    return f


def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, read once."""
    n = _SM_COUNTS.get(index)
    if n is None:
        import torch
        n = _SM_COUNTS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


def stream_ptr(device) -> int:
    """The handle of the device's current stream (read on every call: the
    caller may have made another stream current)."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
