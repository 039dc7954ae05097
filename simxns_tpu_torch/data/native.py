"""ctypes bindings of the C++ fast-collator core (``native/fast_collator.cc``;
port of ``simxns_tpu/data/native.py``).

The source lies outside both packages; the port builds it with ``g++`` at
first use into its own ``simxns_tpu_torch/_build/`` (never into
``native/``, the JAX package's build target) and keeps the JAX signatures
and the ``ABI_VERSION`` check. :func:`available` gates its use: without a
compiler, without the source or at another ABI the collator takes its numpy
path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "fast_collator.cc")
# the port's own build target: native/ is the JAX package's
_BUILD_DIR = os.path.join(_PKG, "_build")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


ABI_VERSION = 3
_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")


def _lib_path() -> str:
    """``_build/libfast_collator-<hash>.so``: the hash covers the source
    and the flags, so an edited source builds anew."""
    with open(_SRC, "rb") as f:
        h = hashlib.sha1(f.read())
    h.update(" ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libfast_collator-{h.hexdigest()[:12]}.so")


def _build() -> Optional[str]:
    """Build the library once with ``g++`` (None without a compiler or
    without the source, e.g. an installed package)."""
    if not os.path.exists(_SRC):
        return None
    path = _lib_path()
    if os.path.exists(path):
        return path
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        # a private temp name, then an atomic rename: concurrent builders
        # (test workers, ranks) never load a half-written library
        tmp = f"{path}.{os.getpid()}.tmp"
        subprocess.run(["g++", *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, path)
        return path
    except (OSError, subprocess.CalledProcessError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.fast_collator_abi_version.restype = ctypes.c_int
        if lib.fast_collator_abi_version() != ABI_VERSION:
            return None
        i8p = ctypes.POINTER(ctypes.c_int8)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.whole_word_mask.argtypes = [
            i32p, ctypes.c_int, u8p, u8p, ctypes.c_double, ctypes.c_uint64, i8p]
        lib.keyword_mask.argtypes = [
            i32p, ctypes.c_int, u8p, u8p, f64p, ctypes.c_double,
            ctypes.c_uint64, i8p]
        lib.dual_mask.argtypes = [
            i32p, ctypes.c_int, u8p, u8p, ctypes.c_uint64, i8p, i8p]
        lib.mask_tokens.argtypes = [
            i32p, i8p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_uint64, i64p]
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.whole_word_mask_batch.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, i32p, u8p, u8p,
            ctypes.c_double, u64p, i8p, ctypes.c_int]
        lib.keyword_mask_batch.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, i32p, u8p, u8p, f64p,
            ctypes.c_double, u64p, i8p, ctypes.c_int]
        lib.dual_mask_batch.argtypes = [
            i32p, ctypes.c_int, ctypes.c_int, i32p, u8p, u8p, u64p,
            i8p, i8p, ctypes.c_int]
        lib.mask_tokens_batch.argtypes = [
            i32p, i8p, ctypes.c_int, ctypes.c_int, ctypes.c_int32,
            ctypes.c_int32, u64p, i64p, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def whole_word_mask(ids: np.ndarray, special: np.ndarray, contin: np.ndarray,
                    probability: float, seed: int) -> np.ndarray:
    lib = _load()
    n = len(ids)
    mask = np.zeros(n, np.int8)
    lib.whole_word_mask(_ptr(ids, ctypes.c_int32), n,
                        _ptr(special, ctypes.c_uint8),
                        _ptr(contin, ctypes.c_uint8),
                        probability, seed, _ptr(mask, ctypes.c_int8))
    return mask


def keyword_mask(ids: np.ndarray, special: np.ndarray, contin: np.ndarray,
                 token_weight: np.ndarray, probability: float,
                 seed: int) -> np.ndarray:
    lib = _load()
    n = len(ids)
    mask = np.zeros(n, np.int8)
    lib.keyword_mask(_ptr(ids, ctypes.c_int32), n,
                     _ptr(special, ctypes.c_uint8),
                     _ptr(contin, ctypes.c_uint8),
                     _ptr(token_weight, ctypes.c_double),
                     probability, seed, _ptr(mask, ctypes.c_int8))
    return mask


def dual_mask(ids: np.ndarray, special: np.ndarray, contin: np.ndarray,
              seed: int):
    lib = _load()
    n = len(ids)
    mask = np.zeros(n, np.int8)
    dual = np.zeros(n, np.int8)
    lib.dual_mask(_ptr(ids, ctypes.c_int32), n,
                  _ptr(special, ctypes.c_uint8),
                  _ptr(contin, ctypes.c_uint8), seed,
                  _ptr(mask, ctypes.c_int8), _ptr(dual, ctypes.c_int8))
    return mask, dual


N_THREADS = max(1, os.cpu_count() or 1)


def _prep_batch(ids: np.ndarray, lens: np.ndarray):
    ids = np.ascontiguousarray(ids, np.int32)
    lens = np.ascontiguousarray(lens, np.int32)
    b, stride = ids.shape
    return ids, lens, b, stride


def whole_word_mask_batch(ids: np.ndarray, lens: np.ndarray,
                          special: np.ndarray, contin: np.ndarray,
                          probability: float, seeds: np.ndarray,
                          n_threads: int = 0) -> np.ndarray:
    """Row-batched whole-word masks: ids [B, stride] padded, lens [B]."""
    lib = _load()
    ids, lens, b, stride = _prep_batch(ids, lens)
    mask = np.zeros((b, stride), np.int8)
    lib.whole_word_mask_batch(
        _ptr(ids, ctypes.c_int32), b, stride, _ptr(lens, ctypes.c_int32),
        _ptr(special, ctypes.c_uint8), _ptr(contin, ctypes.c_uint8),
        probability, _ptr(seeds, ctypes.c_uint64),
        _ptr(mask, ctypes.c_int8), n_threads or N_THREADS)
    return mask


def keyword_mask_batch(ids: np.ndarray, lens: np.ndarray,
                       special: np.ndarray, contin: np.ndarray,
                       token_weight: np.ndarray, probability: float,
                       seeds: np.ndarray, n_threads: int = 0) -> np.ndarray:
    lib = _load()
    ids, lens, b, stride = _prep_batch(ids, lens)
    mask = np.zeros((b, stride), np.int8)
    lib.keyword_mask_batch(
        _ptr(ids, ctypes.c_int32), b, stride, _ptr(lens, ctypes.c_int32),
        _ptr(special, ctypes.c_uint8), _ptr(contin, ctypes.c_uint8),
        _ptr(token_weight, ctypes.c_double), probability,
        _ptr(seeds, ctypes.c_uint64), _ptr(mask, ctypes.c_int8),
        n_threads or N_THREADS)
    return mask


def dual_mask_batch(ids: np.ndarray, lens: np.ndarray, special: np.ndarray,
                    contin: np.ndarray, seeds: np.ndarray,
                    n_threads: int = 0):
    lib = _load()
    ids, lens, b, stride = _prep_batch(ids, lens)
    mask = np.zeros((b, stride), np.int8)
    dual = np.zeros((b, stride), np.int8)
    lib.dual_mask_batch(
        _ptr(ids, ctypes.c_int32), b, stride, _ptr(lens, ctypes.c_int32),
        _ptr(special, ctypes.c_uint8), _ptr(contin, ctypes.c_uint8),
        _ptr(seeds, ctypes.c_uint64), _ptr(mask, ctypes.c_int8),
        _ptr(dual, ctypes.c_int8), n_threads or N_THREADS)
    return mask, dual


def mask_tokens_batch(inputs: np.ndarray, mask: np.ndarray, mask_id: int,
                      vocab_size: int, seeds: np.ndarray,
                      n_threads: int = 0):
    """Row-batched corruption with per-row seeds (inputs [B, L])."""
    lib = _load()
    out = np.ascontiguousarray(inputs, np.int32).copy()
    b, stride = out.shape
    labels = np.zeros((b, stride), np.int64)
    m = np.ascontiguousarray(mask, np.int8)
    lib.mask_tokens_batch(
        _ptr(out, ctypes.c_int32), _ptr(m, ctypes.c_int8), b, stride,
        mask_id, vocab_size, _ptr(seeds, ctypes.c_uint64),
        _ptr(labels, ctypes.c_int64), n_threads or N_THREADS)
    return out, labels


def mask_tokens(inputs: np.ndarray, mask: np.ndarray, mask_id: int,
                vocab_size: int, seed: int):
    lib = _load()
    out = np.ascontiguousarray(inputs, np.int32).copy()
    labels = np.zeros(out.shape, np.int64)
    flat_out = out.reshape(-1)
    flat_mask = np.ascontiguousarray(mask, np.int8).reshape(-1)
    flat_labels = labels.reshape(-1)
    lib.mask_tokens(_ptr(flat_out, ctypes.c_int32),
                    _ptr(flat_mask, ctypes.c_int8), flat_out.size,
                    mask_id, vocab_size, seed,
                    _ptr(flat_labels, ctypes.c_int64))
    return out, labels
