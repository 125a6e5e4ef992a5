"""Build the port's CUDA kernels with nvcc and bind them with ctypes.

Every ``*.cu`` under ``repro_torch/csrc/`` is compiled for sm_90a, one nvcc
per source, all started together, then linked into one shared library with
a plain C interface.  The library lands in ``build/repro_torch/<hash>/`` at
the repository root (gitignored), keyed by a hash of the sources and flags,
so a checkout builds once and an edited source rebuilds.  Nothing is built
at import: the first kernel launch builds and loads.

Each C entry returns ``cudaGetLastError()`` after its launch; `check`
raises on a nonzero code, so a refused launch (too many threads, too much
shared memory) never passes silently.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.core import dct as dct_lib

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "librepro_torch_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points and their argument types (every pointer and the stream
# as c_void_p, so ctypes never truncates an address to 32 bits)
SIGNATURES = {
    "fc_set_dct": (_P,),
    "fc_compress_plane": (_P, _I, _L, _L, _I, _P, _P, _P),
    "fa_set_dct": (_P,),
    "fa_attend_paged": (_P, _P, _P, _P, _P, _I, _P, _P, _I, _I, _P, _P, _I,
                        _P, _I, _I, _I, _I, _I, _I, _F, _P),
}


class LaunchCounter:
    """How many times a wrapper launched its kernel (never its plain path)."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0

    def bump(self) -> None:
        self.count += 1

    def reset(self) -> None:
        self.count = 0


class _Library:
    """The loaded kernel library plus what its build reported."""

    def __init__(self, path: Path, seconds: float, log: str):
        self.path, self.build_seconds, self.build_log = path, seconds, log
        self.lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        self._dct_devices: set[int] = set()

    def fn(self, name: str, device: torch.device):
        """C entry `name`, with the DCT constants uploaded to `device`."""
        idx = device.index if device.index is not None else torch.cuda.current_device()
        if idx not in self._dct_devices:
            c8 = np.ascontiguousarray(dct_lib._dct_matrix_np(8).astype(np.float32))
            with torch.cuda.device(idx):
                for setter in ("fc_set_dct", "fa_set_dct"):
                    check(getattr(self.lib, setter)(c8.ctypes.data), setter)
            self._dct_devices.add(idx)
        return getattr(self.lib, name)


_LIB: _Library | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the repro_torch kernels")


def _sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build() -> tuple[Path, float, str]:
    out_dir = BUILD_ROOT / _key()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path, 0.0, "cached"
    nvcc = _nvcc()
    tmp = BUILD_ROOT / f"{out_dir.name}.tmp{os.getpid()}"
    tmp.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():  # one nvcc per source, all started together
        obj = tmp / (src.stem + ".o")
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    for src, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp / LIB_NAME),
         *sorted(str(p) for p in tmp.glob("*.o"))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    seconds = time.perf_counter() - t0
    try:
        tmp.rename(out_dir)
    except OSError:  # another process finished the same build first
        shutil.rmtree(tmp, ignore_errors=True)
    return lib_path, seconds, "\n".join(logs)


def library() -> _Library:
    """Build (once per source hash) and load the kernel library.

    Raises unless a CUDA device of compute capability 9.0 (Hopper) is
    present: the kernels are compiled for sm_90a only.
    """
    global _LIB
    if _LIB is None:
        if not torch.cuda.is_available():
            raise RuntimeError("repro_torch kernels need a CUDA device")
        cap = torch.cuda.get_device_capability()
        if cap != (9, 0):
            raise RuntimeError(
                f"repro_torch kernels are built for sm_90a (Hopper); this "
                f"device has compute capability {cap}")
        _LIB = _Library(*_build())
    return _LIB


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
