"""Build the port's native code at first use and load it with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (a few seconds, against minutes for
an extension that includes PyTorch's headers); :func:`build` starts one
``nvcc`` per source, all at once. The host rANS coder, ``csrc/rans.cpp``,
compiles with the host C++ compiler (:func:`load_host`). Libraries go to
``ssgvc_tpu_torch/_build/`` (ignored by git), named by a hash of their
sources and flags, so an edited source rebuilds and an unchanged one loads;
each is published with an atomic rename, so concurrent first uses (test
workers, say) never load half a file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# no -march: a library built on one host must load on another (the same
# checkout may run on two machines), and integer rANS needs no vector ISA
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built at "
                       "first use and need the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source whose library is missing, one ``nvcc``
    per source, all started together. Returns each name's compiler output
    (registers, shared memory and spills from ``-Xptxas -v``)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = _lib_path(name)
        log = out.with_suffix(".log")
        if out.exists():
            logs[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, log)
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{text}")
            continue
        log.write_text(text)
        os.replace(tmp, out)      # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.ssgvc_error_string.argtypes = [ctypes.c_int]
            lib.ssgvc_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        msg = lib.ssgvc_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def cxx_path() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the port's rANS coder is built "
                           "at first use with the host C++ compiler")
    return found


def _host_lib_path(name: str) -> Path:
    # the compiler's identity too: a checkout copied to another host with
    # another toolchain builds its own library
    version = subprocess.run([cxx_path(), "--version"], capture_output=True,
                             text=True).stdout
    h = hashlib.sha256(" ".join(CXX_FLAGS + [version]).encode())
    h.update((CSRC / f"{name}.cpp").read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cpp``, built first with the
    host C++ compiler if needed. A failed build raises."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            out = _host_lib_path(name)
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
                proc = subprocess.run(
                    [cxx_path(), *CXX_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{name}.cpp")],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{name}.cpp build failed (exit "
                                       f"{proc.returncode}):\n{proc.stderr}")
                os.replace(tmp, out)
            lib = ctypes.CDLL(str(out))
            _libs[name] = lib
        return lib
