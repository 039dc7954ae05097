"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
into ``_build/lib<name>-<hash>.so`` (the hash covers the source, the shared
headers and the flags), one ``nvcc`` per source, all started together.
Nothing is compiled at import: the first kernel call builds every library
that is missing. Flags: ``sm_90a`` (Hopper), no ``--use_fast_math``, and
``--fmad=false`` so that the epilogues round like their plain PyTorch
versions (the numerical contract is the JAX kernels', not a fused
multiply-add's).
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

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("int8_linear", "small_s_attention", "mips_candidates",
           "group_attention", "bh_attention", "fused_ffn", "int8_ffn")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from csrc/ at first use")
    return path


def lib_path(name: str) -> Path:
    h = hashlib.sha1()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library in parallel; -> seconds per source.

    Raises with the compiler's output if any source fails. The ptxas
    report (registers, shared memory, spills) lands in ``_build/<name>.log``.
    """
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out)
    seconds, errors = {}, []
    for name, (proc, tmp, out) in procs.items():
        stdout, stderr = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(stdout + stderr)
        if proc.returncode:
            errors.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                          f"{stderr[-6000:]}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        lib.sx_error_string.argtypes = [ctypes.c_int]
        lib.sx_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def function(name: str, fn_name: str, argtypes: Sequence,
             restype=ctypes.c_int) -> ctypes._CFuncPtr:
    """The C function ``fn_name`` of ``lib<name>``, typed (built at first
    use)."""
    fn = _FNS.get((name, fn_name))
    if fn is None:
        fn = getattr(load(name), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FNS[(name, fn_name)] = fn
    return fn


def check(name: str, code: int, what: str) -> None:
    """Raise on the ``cudaGetLastError`` code a C launcher of ``lib<name>``
    returned."""
    if code != 0:
        msg = load(name).sx_error_string(code).decode()
        raise RuntimeError(f"{what}: kernel launch failed: CUDA error "
                           f"{code} ({msg})")


def check_tensor(t: torch.Tensor, dtype: torch.dtype, shape,
                 name: str) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous, 16-byte
    aligned CUDA tensor of ``dtype`` and ``shape``."""
    if (t is None or t.dtype != dtype or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or not t.is_cuda
            or t.data_ptr() % 16):
        got = ("None" if t is None else
               f"{t.dtype} {tuple(t.shape)} on {t.device}")
        raise ValueError(
            f"{name}: expected a contiguous, 16-byte aligned CUDA {dtype} "
            f"tensor of shape {tuple(shape)}, got {got}")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
