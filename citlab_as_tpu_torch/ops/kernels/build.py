"""Build the port's native libraries and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own with nvcc, and each
``csrc/<name>.cpp`` (host code) with the host C++ compiler (``$CXX``, else
``g++``), with a plain C interface, into
``build/citlab_kernels/<name>-<hash>.so`` at the repository root (listed in
``.gitignore``). The hash covers the source, every header in ``csrc/``, the
compiler flags (and, for host code built with ``-march=native``, the host
CPU's feature flags), so an edited source or header rebuilds and an
unchanged one loads at once. ``build_all`` starts one compiler per source,
all together. A failed build raises;
nothing here is imported or run until a kernel is first launched on a CUDA
tensor, or the host library is first called.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "citlab_kernels")
KERNEL_SOURCES = ("conv3x3", "separator_morphology")
HOST_SOURCES = ("geometry_host", "image_decode", "image_encode", "webp_decode",
                "jpeg2000_decode", "raster_decode", "bcn_decode", "av1_decode",
                "zstd_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the JAX package's native/Makefile flags: -march=native lets the compiler
# fuse multiply-adds exactly as in the reference's host library, so the two
# agree bit for bit on the same host (numpy, which never fuses, agrees to
# the last bits of a double)
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
# the image writer reproduces Pillow's float expressions, the decoder
# libtiff's YCbCr coefficients and the JPEG 2000 decoder OpenJPEG's, which
# their generic x86-64 builds never fuse
EXTRA_FLAGS = {"image_encode": ("-ffp-contract=off",), "image_decode": ("-ffp-contract=off",),
               "jpeg2000_decode": ("-ffp-contract=off",), "av1_decode": ("-ffp-contract=off",)}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def _cxx() -> str:
    cxx = os.environ.get("CXX") or "g++"
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"host C++ compiler {cxx!r} not found (set CXX)")
    return found


def _source(name: str) -> Tuple[str, Tuple[str, ...]]:
    """(source path, compiler flags) of ``csrc/<name>``."""
    if name in HOST_SOURCES:
        return os.path.join(CSRC_DIR, name + ".cpp"), CXX_FLAGS + EXTRA_FLAGS.get(name, ())
    return os.path.join(CSRC_DIR, name + ".cu"), NVCC_FLAGS


def _host_cpu() -> bytes:
    """The host CPU's feature flags: ``-march=native`` code built on one
    machine need not run on another, so the host library's hash covers
    them."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.processor().encode()


def _lib_path(name: str) -> str:
    src, flags = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    for header in sorted(glob.glob(os.path.join(CSRC_DIR, "*.h"))):
        with open(header, "rb") as f:
            digest.update(f.read())
    if name in HOST_SOURCES:
        digest.update(_host_cpu())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _start_build(name: str) -> Optional[Tuple[subprocess.Popen, str, str]]:
    """Start the compiler for one source unless its library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    src, flags = _source(name)
    compiler = _cxx() if name in HOST_SOURCES else _nvcc()
    cmd = [compiler, *flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"build failed for {os.path.relpath(_source(name)[0], _PKG_DIR)} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)   # atomic, so concurrent builders never see a torn file


def build_all(names: Iterable[str] = KERNEL_SOURCES) -> None:
    """Compile every listed source, one compiler each, all started together."""
    names = list(names)
    with _lock:
        procs = {n: _start_build(n) for n in names}
        for n in names:
            _finish_build(n, procs[n])


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(_lib_path(name))
            _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise for a nonzero cudaError_t returned by an entry point of ``lib``,
    naming it with the library's ``citlab_error_string``
    (``cudaGetErrorString``), so that a refused launch says why."""
    if err != 0:
        name = lib.citlab_error_string
        name.argtypes, name.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} at launch "
                           f"({name(err).decode()})")
