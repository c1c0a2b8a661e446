"""Build the CUDA sources under ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface: every entry point takes
device pointers and a ``cudaStream_t`` and returns the
``cudaGetLastError()`` of its launch.  A library is built at first use
into ``build/repro_torch_kernels/`` at the repository root, under a name
keyed on a hash of its source and the compiler flags, so an edited
source builds anew.  Nothing is compiled or loaded at import time: the
CPU tests import every module on machines without nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_layouts_checked = set()


def nvcc() -> str:
    """The nvcc of ``$CUDA_HOME``, else the one on ``PATH``, else the
    toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Tuple[float, str]]:
    """Compile every named source not yet built, one nvcc per source, all
    started together.  Returns (wall seconds, nvcc and ptxas output) per
    compiled source; raises with nvcc's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    done, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        done[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)       # atomic: a reader never sees half a .so
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _libs[name] = lib
    return lib


def launch(lib: str, name: str, argtypes: Sequence, *args) -> None:
    """Call the entry point ``name`` of ``csrc/<lib>.cu`` with ``args``;
    raise if it returns a CUDA error (a refused launch never runs, and
    no later synchronise would report it)."""
    fn = getattr(load(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def check_layout(lib: str, entry: str, struct) -> None:
    """Raise unless the entry point ``entry`` of ``csrc/<lib>.cu`` (the
    ``sizeof`` of a C argument struct) equals ``ctypes.sizeof(struct)``,
    the Python mirror that a launch passes by address.  Asked once per
    process."""
    if (lib, entry) in _layouts_checked:
        return
    fn = getattr(load(lib), entry)
    fn.argtypes = []
    fn.restype = ctypes.c_int
    if fn() != ctypes.sizeof(struct):
        raise RuntimeError(f"{lib}.cu: {entry}() = {fn()} bytes, the ctypes "
                           f"mirror {ctypes.sizeof(struct)}")
    _layouts_checked.add((lib, entry))


def check(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape``: what every kernel's pointer arithmetic assumes."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {tuple(shape)} {dtype}, got "
                         f"{tuple(t.shape)} {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream(t: torch.Tensor) -> int:
    """The handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
