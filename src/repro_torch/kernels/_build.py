"""Build and load the CUDA kernels: ``nvcc`` into one ``.so``, bound by ctypes.

The sources under ``repro_torch/csrc/`` have a plain C interface (no
PyTorch headers), so a build takes seconds. Each ``.cu`` compiles to an
object in its own ``nvcc`` process, all started together, and one more
``nvcc`` links them into a shared library. The library lives in
``build/kernels/<key>/`` at the root of the checkout (listed in
``.gitignore``), where ``<key>`` hashes the sources, the flags and the
compiler's version, so an edit or a new toolkit rebuilds and an unchanged
tree reuses the library. The build happens at first use, never at import.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on a non-zero code. There is no fallback: without ``nvcc``
or on a failed build, ``library()`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

__all__ = ["SOURCES", "build_dir", "check", "library", "nvcc_path"]

_CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("block_min.cu", "fused_query.cu")
_HEADERS = ("common.cuh",)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "repro_block_min_f32": (_P, _P, _P, _I, _I, _I, _P),
    "repro_block_min_i32": (_P, _P, _P, _I, _I, _I, _P),
    "repro_fused_query_f32": (_P,) * 10 + (_I,) * 5 + (_P,),
    "repro_fused_query_i32": (_P,) * 10 + (_I,) * 5 + (_P,),
}

_lock = threading.Lock()
_lib = None
# What the last build printed (``-Xptxas -v``: registers, spills per kernel)
# and how long it took; None when the library came from an earlier build.
build_log = None
build_seconds = None


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found (not on PATH, not /usr/local/cuda/bin/nvcc): the "
            "repro_torch CUDA kernels are built with the CUDA toolkit at first "
            "use; CPU tensors take the plain PyTorch path instead"
        )
    return found


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "kernels"


def _key(nvcc: str) -> str:
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True)
    h = hashlib.sha256(version.stdout.encode())
    h.update(" ".join(_FLAGS).encode())
    for name in SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out: Path) -> str:
    """Compile every source in parallel, link, and move the library into place."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs, procs = [], []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            objs.append(str(obj))
            cmd = [nvcc, *_FLAGS, "-c", str(_CSRC / src), "-o", str(obj)]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs.append((src, p))
        logs, failed = [], []
        for src, p in procs:
            text, _ = p.communicate()
            logs.append(f"--- {src}\n{text}")
            if p.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / _LIB_NAME
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", *objs, "-o", str(tmp_lib)],
            capture_output=True,
            text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
        os.replace(tmp_lib, out)  # atomic: a concurrent build never sees half a file
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib, build_log, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        nvcc = nvcc_path()
        out = build_dir() / _key(nvcc) / _LIB_NAME
        if not out.exists():
            t0 = time.perf_counter()
            build_log = _compile(nvcc, out)
            build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(out))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(code: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        msg = library().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
