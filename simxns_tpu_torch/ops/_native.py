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

import contextlib
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
           "attention_fwd_wgmma", "attention_bwd_wgmma", "fused_ffn",
           "int8_ffn", "ffn_fwd")
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


def on(device: torch.device):
    """The context of a launch for tensors on ``device``: the runtime (and
    Triton) launch on the current device, so ``device`` is made current for
    the launch when it is not (a data-parallel rank's tensors live on its
    own card, whatever the process's current device)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device.index)


def launch(fn: ctypes._CFuncPtr, device: torch.device, *args) -> int:
    """Call the C launcher ``fn`` on ``device`` (:func:`on`), with the
    device's current stream as its last argument. -> its error code."""
    with on(device):
        return fn(*args, stream(device))


# --- the tiles of the persistent wgmma GEMM (csrc/wgmma_gemm.cuh) -----------

_SMS: Dict[int, int] = {}


def sm_count(device) -> int:
    """The streaming multiprocessors of a CUDA device (132 on an H100)."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def wgmma_tile(m: int, n: int, sms: int) -> Tuple[int, int]:
    """(BM, BN) of an [m, n] output on ``sms`` SMs: 128 x 256 from two
    waves of its tiles, else 64 x 128 where its tiles fill the SMs, else
    64 x 64 (measured on K1, H100, ``scripts/torch_kernel_bench.py`` with
    each tile forced: 128 x 256 beat 64 x 128 by 8-42% from 4.8 waves and
    lost by 7-25% at 1.1-1.5; 64 x 128 beat 64 x 64 by 16-23% at 2,048
    rows; 64 x 64 won at 256)."""
    def tiles(bm, bn):
        return -(-m // bm) * -(-n // bn)

    if tiles(128, 256) >= 2 * sms:
        return 128, 256
    if tiles(64, 128) >= sms:
        return 64, 128
    return 64, 64


def mips_tile(q: int, n_pad: int, bucket: int, sms: int) -> Tuple[int, int]:
    """(BM, BN) of K4 for ``q`` queries over ``n_pad`` corpus columns on
    ``sms`` SMs (``csrc/mips_candidates.cu``; its kernels exist at 128 x 256
    and 64 x 128, and at 64 x 128 only for buckets under 8).

    - Up to 64 queries 64 x 128: one consumer warpgroup (a 128-row tile
      would have its second warpgroup multiply zero rows), and two blocks an
      SM, so that one block's epilogue overlaps the other's products. The
      search is bound by the corpus's bytes there (6.8 GB int8 at 8.8M x
      768).
    - Above, 128 x 256 once its tiles fill the SMs: the densest tile (a byte
      landed feeds 85 int8 operations), whose products alone run at ~80% of
      the int8 peak at 1024 queries.
    - Else 64 x 128, so that more SMs take part.
    """
    if bucket < 8 or q <= 64:
        return 64, 128
    if -(-q // 128) * -(-n_pad // 256) >= sms:
        return 128, 256
    return 64, 128


_PEAK_BF16 = 989e12    # H100 SXM dense bf16 tensor-core flop/s
_PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
_MAX_SPLITS = 8
_MIN_SPLIT_ROWS = 1024


def dw_tile(m: int, h: int, f: int, sms: int) -> Tuple[int, int, int]:
    """(BM, BN, splits) of K11: dW1 [f, h] and dW2 [h, f], both over K = m
    rows, as one launch of the wgmma GEMM on ``sms`` SMs.

    K here is long and the outputs small (at the CE-large step 20,480 rows
    against 128 + 128 tiles of 128 x 256), the opposite of
    :func:`wgmma_tile`'s case: a tile's products, not its epilogue, are
    what it costs. So:

    - below 2,048 rows (32 k-tiles) K is short and the rule is
      :func:`wgmma_tile`'s, counted over both products' tiles;
    - else 128 x 256, the densest tile (each byte landed feeds 85 flop),
      and K cut into ``splits`` parts where the tiles alone leave SMs idle
      (DE passages: 72 + 72 tiles on 132 SMs, a second wave for 12 SMs).
      Each split writes its own f32 partial output, which a second pass
      adds in order (no atomics: the same bits every run). The split
      minimises the least time of the launch: its waves of tiles, each at
      the SM's share of the bf16 peak, plus the partials written and read
      again at the memory rate; at most 8 parts, none below 1,024 rows
      (the ring's fill and the f32 tile store stay small beside a part).
    """
    def tiles(bm, bn):
        return (-(-f // bm) * -(-h // bn)) + (-(-h // bm) * -(-f // bn))

    if m < 2 * _MIN_SPLIT_ROWS:
        if tiles(128, 256) >= 2 * sms:
            return 128, 256, 1
        if tiles(64, 128) >= sms:
            return 64, 128, 1
        return 64, 64, 1
    n = tiles(128, 256)
    per_sm = _PEAK_BF16 / sms
    partial_bytes = 2 * h * f * 4

    def seconds(s):
        waves = -(-n * s // sms)
        t = waves * 2.0 * 2 * 128 * 256 * -(-m // s) / per_sm
        return t + (2 * s * partial_bytes / _PEAK_BYTES if s > 1 else 0.0)

    splits = min(range(1, min(_MAX_SPLITS, m // _MIN_SPLIT_ROWS) + 1),
                 key=seconds)
    return 128, 256, splits
