"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes). The library lands in ``build/paddle_tpu_torch/`` at the
repository root, named by a hash of its source, the ``csrc/`` headers it
includes (``HEADERS``) and the compiler flags: an edited source or header
gets a new name and is rebuilt, an unchanged one is loaded as it is. ``build()`` starts one nvcc per stale source, all at
once, and waits for them together. Every C entry point returns
``cudaGetLastError()`` after its launch; ``check`` turns a non-zero code
into an exception.

Nothing here runs at import: the CPU tests import every module of the
port on a machine without nvcc.
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

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "paddle_tpu_torch"
SOURCES = ("flash_attention", "flash_attention_bwd", "paged_attention",
           "fused_ce", "mma_probe", "w8_gemm")
# the csrc/ headers each source includes (hashed with it)
HEADERS = {"fused_ce": ("f32_gemm.cuh", "f32_tiles.cuh", "wgmma_bf16.cuh"),
           "flash_attention": ("f32_tiles.cuh", "segment_ids.cuh",
                               "wgmma_bf16.cuh"),
           "flash_attention_bwd": ("f32_tiles.cuh", "segment_ids.cuh",
                                   "wgmma_bf16.cuh"),
           "mma_probe": ("mma_bf16.cuh", "wgmma_bf16.cuh"),
           "w8_gemm": ("mma_bf16.cuh", "wgmma_bf16.cuh")}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the element types the C entry points take, by the code they expect (2 is
# the paged kernels' int8 pool code): the one table of which dtypes a
# kernel takes
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 3}

_libs = {}
_lock = threading.Lock()


def _nvcc():
    for path in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("paddle_tpu_torch: nvcc not found; the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def library_path(name):
    text = (CSRC / (name + ".cu")).read_bytes()
    for header in HEADERS.get(name, ()):
        text += (CSRC / header).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / ("%s-%s.so" % (name, digest[:16]))


def build(names=SOURCES):
    """Compile every library in ``names`` whose hashed file is missing,
    all nvcc processes running at once. Returns ``{name: path}``; the
    compiler's output (ptxas register and spill report) is kept beside
    each library as ``<library>.log``. Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths, running = {}, []
    for name in names:
        path = library_path(name)
        paths[name] = path
        if path.exists():
            continue
        tmp = path.with_name("%s.tmp%d" % (path.name, os.getpid()))
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / (name + ".cu"))]
        running.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, path, tmp, proc in running:
        log, _ = proc.communicate()
        path.with_name(path.name + ".log").write_text(log)
        if proc.returncode == 0:
            os.replace(tmp, path)
        else:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, log))
    if failed:
        raise RuntimeError("paddle_tpu_torch: kernel build failed: "
                           + "\n".join(failed))
    return paths


def load(name, signatures):
    """The loaded library for ``csrc/<name>.cu``, building it if needed.
    ``signatures`` maps each C function to its ctypes ``argtypes``; every
    function returns an int (a ``cudaError_t``). Pointers and the stream
    are ``c_void_p``, so ctypes never cuts a 64-bit address."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build((name,))[name]))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.pt_error_string.argtypes = [ctypes.c_int]
            lib.pt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib, err, what):
    if err:
        raise RuntimeError("%s: CUDA error %d (%s)" % (
            what, err, lib.pt_error_string(err).decode()))


def stream_handle(device):
    """PyTorch's current stream on ``device``, as the C side takes it."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
