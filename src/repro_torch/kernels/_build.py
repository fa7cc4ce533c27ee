"""Build and bind the CUDA sources in ``kernels/csrc/``.

Each ``csrc/<stem>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/lib<stem>-<hash>.so

No ``--use_fast_math``: the histogram's bins must come from IEEE division
to match the reference, and the map bodies' ``expf``/``sqrtf`` must be
the IEEE ones. The file name carries a hash of the source and
the flags, so an edited source never loads a stale library. The build
runs at first use, all sources at once (one ``nvcc`` each), under a file
lock, and each library appears by an atomic rename, so several processes
(the ranks of a distributed sort) may reach it together. ``nvcc``'s
report (registers, shared memory, spills) is kept beside each library
as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("bitonic", "hist", "search", "map", "reduce", "scan", "nucleus",
           "page", "attention")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_loads = 0


def build_dir() -> Path:
    """``<repo>/build/kernels`` for a source checkout (``src/`` layout),
    else ``build/kernels`` inside the installed package."""
    pkg = Path(__file__).resolve().parents[1]
    root = pkg.parents[1] if pkg.parent.name == "src" else pkg
    return root / "build" / "kernels"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are built from source at first "
        "use and need the CUDA toolkit (PATH or /usr/local/cuda/bin)"
    )


def _lib_path(stem: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [CSRC / f"{stem}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(f.read_bytes())
    digest = h.hexdigest()
    return build_dir() / f"lib{stem}-{digest[:16]}.so"


def build_all(stems=SOURCES) -> dict[str, Path]:
    """Compile every missing library, all ``nvcc`` processes at once.
    Returns {stem: library path}. Raises with the compiler's output if
    any build fails."""
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {s: _lib_path(s) for s in stems}
    with open(out / ".lock", "w") as lockf:
        fcntl.flock(lockf, fcntl.LOCK_EX)
        try:
            procs = {}
            for stem, path in paths.items():
                if path.exists():
                    continue
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                log = open(path.with_suffix(".log"), "w")
                procs[stem] = (subprocess.Popen(
                    [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                     str(CSRC / f"{stem}.cu")],
                    stdout=log, stderr=subprocess.STDOUT,
                ), tmp, log)
            failed = []
            for stem, (proc, tmp, log) in procs.items():
                rc = proc.wait()
                log.close()
                if rc != 0:
                    failed.append(stem)
                    tmp.unlink(missing_ok=True)
                else:
                    os.replace(tmp, paths[stem])
            if failed:
                logs = "\n".join(
                    paths[s].with_suffix(".log").read_text() for s in failed
                )
                raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
        finally:
            fcntl.flock(lockf, fcntl.LOCK_UN)
    return paths


def loads() -> int:
    """Libraries built or loaded by this process so far (the registry
    counts a call that made none as a cache hit)."""
    return _loads


def library(stem: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (built on first use), with
    ``argtypes`` set from ``signatures`` = {function: [ctypes types]}.
    Every entry point returns ``cudaGetLastError()`` as an int."""
    global _loads
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            path = build_all()[stem]
            lib = ctypes.CDLL(str(path))
            lib.ak_error_string.argtypes = [ctypes.c_int]
            lib.ak_error_string.restype = ctypes.c_char_p
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _libs[stem] = lib
            _loads += 1
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err != 0:
        msg = lib.ak_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


#: dtype codes of csrc/ak_common.cuh (enum AkDtype); bool only as the
#: output of a logical reduction
DTYPE_CODES = {torch.float32: 0, torch.int32: 1, torch.bfloat16: 2}
BOOL_CODE = 3


def dtype_code(dtype: torch.dtype, what: str) -> int:
    try:
        return DTYPE_CODES[dtype]
    except KeyError:
        raise TypeError(
            f"{what}: the CUDA kernel takes float32, int32 or bfloat16 "
            f"operands, got {dtype}"
        ) from None


def as_double(value, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` and widened to a Python float (exact:
    every float32, int32, bfloat16 and bool value is a double), the form
    in which scalars such as identities and inits reach the kernels."""
    if isinstance(value, torch.Tensor):
        value = value.item()
    return float(torch.tensor(value, dtype=dtype).to(torch.float64))


def stream_handle(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
