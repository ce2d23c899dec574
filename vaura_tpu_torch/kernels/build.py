"""Build the CUDA sources in ``csrc/`` with ``nvcc`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``_build/<name>-<hash>.so`` (the directory is git-ignored), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

The hash covers the source, the shared header and the flags, so an edited
source is rebuilt and an unchanged one is reused. ``build_all`` starts one
``nvcc`` per source at once and waits for all of them; ``load`` builds on
first use and opens the library with ``ctypes``. Every launch function
returns ``cudaGetLastError()`` taken right after its launches, and
``check`` raises on anything but ``cudaSuccess``: a refused launch (too many
threads, too much shared memory) never runs and no later synchronise would
report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("decode_attention", "encoder_attention", "encoder_mlp",
           "grouped_cls_attention", "snake", "decode_block")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """The compiler's output (registers, shared memory, spills) of the
    current build of ``name``, or '' when it has not been built."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current build, one ``nvcc``
    process each, all started together. Raises with the compiler's output
    if any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, so in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        so.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {name} (exit {proc.returncode}) ---\n{out}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and open it. ``signatures`` maps
    each exported function to its argument types; every one returns the
    launch's CUDA error code as an int."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            so = build_all([name])[name]
            lib = ctypes.CDLL(str(so))
            lib.vt_error_string.argtypes = [ctypes.c_int]
            lib.vt_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.vt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current stream on ``device`` as a pointer for a launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())

