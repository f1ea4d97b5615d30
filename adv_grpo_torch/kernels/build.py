"""Build the port's CUDA kernels once per process and load them with ctypes.

All sources under ``adv_grpo_torch/csrc/*.cu`` are compiled by ``nvcc`` (one
process per source, in parallel) and linked into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds). The
library is named after a hash of the sources and headers and written
into ``adv_grpo_torch/kernels/_build/`` (git-ignored); a process that finds a
library of the current hash there loads it without compiling.

Every C entry point returns ``cudaGetLastError()``; :func:`check` turns a
non-zero code into an exception, so a refused launch (too many threads, too
much shared memory, wrong architecture) never passes silently.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # x, scale, shift, y, rows, rows_per_batch, d, scale/shift row strides,
    # eps, stream
    "lnmod_bf16": [_P, _P, _P, _P, _LL, _I, _I, _LL, _LL, _F, _P],
    # x, y, rows, d, eps, stream
    "ln_bf16": [_P, _P, _LL, _I, _F, _P],
    # x, w, y, rows, rows_per_batch, hd, d, x batch/row strides, eps, stream
    "rms_heads_bf16": [_P, _P, _P, _LL, _I, _I, _I, _LL, _LL, _F, _P],
    # the fp32 instances of the three norms, as their bf16 entries
    "lnmod_f32": [_P, _P, _P, _P, _LL, _I, _I, _LL, _LL, _F, _P],
    "ln_f32": [_P, _P, _LL, _I, _F, _P],
    "rms_heads_f32": [_P, _P, _P, _LL, _I, _I, _I, _LL, _LL, _F, _P],
    # the generic attention: stream descriptors, streams, dtype (0 fp32, 1
    # bf16), mode, batch, heads, head dim, qscale, eps, stream
    "attention_generic_fwd": [_P, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # the same, with sm_scale before eps
    "attention_generic_bwd": [_P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _P],
    # image q/k/v/o/lse/len, text q/k/v/o/lse/len, strides, 4 RMS weights,
    # image and text k^ scratch, batch, heads, head dim, qscale, eps, stream
    "joint_attention_fwd_bf16": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _P,
                                 _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    # q, k, v, o, lse, len, strides, wq, wk, k^ scratch, batch, heads, head
    # dim, qscale, eps, stream
    "mha_rms_fwd_bf16": [_P, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    # q, k, v, o, lse, q rows, kv_len, strides, batch, heads, head dim,
    # qscale, stream
    "mha_bshd_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _I, _F, _P],
    # q, k, v, o, lse, q rows, kv rows, kv_len, batch, heads, head dim,
    # qscale, stream
    "mha_fwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
    # per stream (image, then text): q, k, v, do, lse, di, dq, dk, dv, len;
    # strides, 4 RMS weights, operand scratch, dq scratch, batch, heads, head
    # dim, sm_scale, qscale, eps, stream
    "joint_attention_bwd_bf16": [_P] * 9 + [_I] + [_P] * 9 + [_I] + [_P] * 7
                                + [_I, _I, _I, _F, _F, _F, _P],
    # q, k, v, do, lse, di, dq, dk, dv, len, strides, wq, wk, operand scratch,
    # dq scratch, batch, heads, sm_scale, qscale, eps, stream
    "mha_rms_bwd_bf16": [_P] * 9 + [_I] + [_P] * 5 + [_I, _I, _F, _F, _F, _P],
    # q, k, v, do, lse, di, dq, dk, dv, dq scratch, dk/dv scratch, q splits,
    # q rows, kv rows, kv_len, strides, batch, heads, head dim, sm_scale, stream
    "mha_bshd_bwd_bf16": [_P] * 11 + [_I, _I, _I, _I, _P, _I, _I, _I, _F, _P],
    # q, k, v, do, lse, di, dq, dk, dv, dq scratch, dk/dv scratch, q splits,
    # q rows, kv rows, kv_len, batch, heads, head dim, sm_scale, stream
    "mha_bwd_bf16": [_P] * 11 + [_I] * 7 + [_F, _P],
}

_lib = None
build_seconds = None  # wall time of this process's build; None if loaded/unbuilt
build_log = ""  # nvcc's output (ptxas register / spill report) of that build


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _headers():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    # PyTorch's own search: $CUDA_HOME / $CUDA_PATH, nvcc on $PATH, the
    # default toolkit location
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _library_path(sources) -> str:
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libadvgrpo_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources if no library of their hash exists; return its path.

    Each source compiles in its own ``nvcc`` process, all started together;
    one more ``nvcc`` links the objects into the shared library."""
    global build_seconds, build_log
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    out = _library_path(sources + _headers())
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        nvcc = _nvcc()
        objs = [os.path.join(tmpdir, os.path.basename(s) + ".o") for s in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, s],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True)
                 for s, o in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, log) for s, p, log in zip(sources, procs, logs)
                  if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{os.path.basename(s)} ({rc}):\n{log}" for s, rc, log in failed))
        tmp = os.path.join(tmpdir, "lib.so")
        link = subprocess.run([nvcc, *LINK_FLAGS, "-o", tmp, *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent process sees all or none
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {rc}")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device`` (a tensor's device, which
    names its index), as a raw pointer, read without building a
    ``torch.cuda.Stream`` object."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
