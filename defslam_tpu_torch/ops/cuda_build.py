"""Build the port's CUDA kernels at first use and count their launches.

Each kernel is one ``csrc/<name>.cu`` with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``defslam_tpu_torch/
_build/`` (listed in ``.gitignore``) and loaded with ``ctypes``.  The
library's file name carries a hash of the source and the flags, so an edited
source builds anew and an unchanged one is reused.  Nothing is built or
loaded at import: the CPU tests import every module.

``LAUNCHES`` counts kernel launches by name; each wrapper adds one where it
launches its kernel, so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# argtypes / restype of each library's entry point
SIGNATURES = {
    "hamming": (
        "hamming_matrix_launch",
        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "windowed_match": (
        "windowed_match_launch",
        [ctypes.c_void_p] * 9
        + [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
           ctypes.c_void_p],
        ctypes.c_int,
    ),
}

LAUNCHES: collections.Counter = collections.Counter()
# name -> the loaded library's entry point; filled under the lock at a
# kernel's first use, read without it on every later call
_ENTRY: dict[str, object] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names=tuple(SIGNATURES)) -> dict[str, dict]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns, per name, the build seconds
    (0 when the library existed) and nvcc's ``-Xptxas -v`` report.  Raises
    with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        path = library_path(name)
        if path.exists():
            continue
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    report = {name: {"seconds": 0.0, "log": ""} for name in names}
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, path)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str):
    """The entry point of the kernel's library, with its argtypes and
    restype set; the library is built first if needed."""
    with _LOCK:
        fn = _ENTRY.get(name)
        if fn is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            fn_name, argtypes, restype = SIGNATURES[name]
            fn = getattr(ctypes.CDLL(str(path)), fn_name)
            fn.argtypes = argtypes
            fn.restype = restype
            _ENTRY[name] = fn
        return fn


def launch(name: str, device, *args) -> None:
    """Call the entry point of kernel ``name`` with ``args`` and the
    current stream of ``device`` (a ``torch.device`` of type cuda); raise if
    the launch was refused.  The library is built and loaded at the first
    call; later calls take no lock, and enter a device context only when
    ``device`` is not the current one."""
    fn = _ENTRY.get(name) or load(name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, _stream_handle(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, _stream_handle(index))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _stream_handle(index: int) -> int:
    """The current stream of device ``index`` as the integer the C interface
    takes: the raw handle, without the Stream object that
    ``current_stream()`` builds (9 us a call against under 1 on an H100's
    host)."""
    return torch._C._cuda_getCurrentRawStream(index)
