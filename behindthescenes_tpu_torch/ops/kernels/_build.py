"""Build the port's CUDA kernels once, at first use, load and call them.

Every `csrc/*.cu` goes through ONE nvcc call into one shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so the build
takes seconds, not minutes). The library lands in `_build/` inside the
package, named by a hash of the sources and flags, so a second run loads
what the first one built. Nothing here runs at import time: the CPU tests
import every module of the port on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
CUDA_ROOTS = ("/usr/local/cuda",)   # searched after $CUDA_HOME, before PATH
# -Xptxas -v: ptxas reports each kernel's registers, stack and spills;
# `build` keeps the report beside the library (`ptxas_report` reads it).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported launcher: pointers and the stream as
# c_void_p (a bare Python int would be cut to 32 bits), sizes as c_int.
# Each returns cudaGetLastError() after its launch.
_SHARED_Z = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
_JITTER = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
SIGNATURES = {
    "bts_shared_z_tail": _SHARED_Z,
    "bts_shared_z_tail_bf16": _SHARED_Z,
    "bts_shared_z_tail_any": _SHARED_Z,
    "bts_shared_z_tail_any_bf16": _SHARED_Z,
    "bts_jitter_density": _JITTER,
    "bts_jitter_density_any": _JITTER,
    "bts_selfview_density": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _F, _P],
}

_lock = threading.Lock()
_lib = None


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels build only on a machine with the CUDA "
                           "toolkit")
    return found


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libbts_kernels_{source_hash()}.so")


def build() -> str:
    """Compile every csrc/*.cu into _build/ unless this exact build is
    there already, and keep ptxas's report in `<library>.ptxas.txt`.
    Returns the library's path; raises with nvcc's stderr if the build
    fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Ranks started together build once: the others wait on the lock and
    # find the library.
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out):
            return out
        return _compile(nvcc, out)


def _compile(nvcc: str, out: str) -> str:
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
           *[s for s in sources() if s.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    with open(f"{out}.ptxas.txt", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def parse_ptxas(text: str) -> dict:
    """ptxas -v output -> {mangled kernel name: {"registers", "stack",
    "spill_stores", "spill_loads"}} (bytes, per thread)."""
    report, name, props = {}, None, None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            name = m.group(1)
            report[name] = {}
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif (m := _FRAME.search(line)) and props in report:
            report[props].update(zip(("stack", "spill_stores",
                                      "spill_loads"), map(int, m.groups())))
        elif name and (m := _REGS.search(line)):
            report[name]["registers"] = int(m.group(1))
    return report


def ptxas_report() -> dict:
    """`parse_ptxas` of the report the current build kept."""
    with open(f"{library_path()}.ptxas.txt") as f:
        return parse_ptxas(f.read())


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.bts_error_string.argtypes = [ctypes.c_int]
            lib.bts_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        text = library().bts_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: {text} ({err})")


# What the kernels are built for (a template constant): the hidden widths
# and the octave count of the shipped configs whose decoder fuses (a
# ResnetFC with no blocks). shared_z and jitter_density launch their
# runtime-shape kernels for any other width.
DECODE_H = (32, 64)
DECODE_N_FREQS = 6


def check_decode_shapes(k: int, h: int, n_freqs: int, k_multiple: int,
                        name: str) -> None:
    """Raise unless a jittered decode kernel takes K samples per ray of
    width H with n_freqs octaves: H in DECODE_H, 6 octaves, K a multiple
    of `k_multiple`. Pure Python, called before any build or launch."""
    if h not in DECODE_H:
        raise ValueError(f"{name}: H={h}, the CUDA kernel is built for H in "
                         f"{DECODE_H}, the widths of the shipped configs "
                         "whose decoder fuses")
    if n_freqs != DECODE_N_FREQS:
        raise ValueError(f"{name}: n_freqs={n_freqs}, the CUDA kernel is "
                         f"built for {DECODE_N_FREQS} octaves, as every "
                         "shipped config uses")
    if k % k_multiple != 0:
        raise ValueError(f"{name}: K={k}, the CUDA kernel takes samples in "
                         f"groups of {k_multiple}")


def require(t, name: str, dtype, shape, device, align: int = 1) -> None:
    """Raise unless `t` is a contiguous tensor of this dtype and shape on
    this device, its data `align`-byte aligned: the kernels take raw
    pointers and no strides."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data not {align}-byte aligned")
