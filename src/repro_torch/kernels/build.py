"""Build and load the port's CUDA kernel library, and count launches.

The kernels under ``csrc/`` are plain CUDA C++ with a C interface. At
first use on a machine with ``nvcc`` they are compiled for Hopper
(``sm_90a``), one ``nvcc`` per source started together, linked into one
shared library under ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``) and loaded with ``ctypes``. The library's
file name carries a hash of the sources and flags, so an edited kernel
is rebuilt and a built one is reused.

Nothing here runs at import time: the CPU tests import every module of
the port on machines with no ``nvcc`` and no card.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# One count per kernel, raised by its wrapper each time the kernel is
# launched, and nowhere else. A run resets them to show which kernels
# its path went through.
LAUNCHES: collections.Counter = collections.Counter()

_VP, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "qf_zgemm": ([_VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP], _INT),
    "qf_ect_parts": ([_INT] * 7, _INT),
    "qf_ect": ([_VP] * 4 + [_INT] * 8 + [_VP], _INT),
    "qf_fidelity": ([_VP, _VP, _VP, _INT, _INT, _VP], _INT),
    "qf_mse": ([_VP, _VP, _VP, _INT, _INT, _VP], _INT),
    "qf_flash_attention": ([_VP] * 6 + [_INT] * 8 + [_VP], _INT),
    "qf_flash_attention_bwd": ([_VP] * 12 + [_INT] * 9 + [_VP], _INT),
    "qf_rglru_scan": ([_VP] * 3 + [_INT] * 4 + [_VP], _INT),
    "qf_gla_chunked": ([_VP] * 7 + [_INT] * 7 + [_VP], _INT),
    "qf_error_string": ([_INT], ctypes.c_char_p),
}

_lock = threading.Lock()
_lib = None


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "on a machine with the CUDA toolkit")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libqf_kernels_{_digest()}.so"


def build() -> Path:
    """Compile every source in parallel and link the shared library (a
    no-op when the library for these sources exists). Returns its path;
    the compiler's resource report is kept beside it as ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [cc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o",
                   str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            log.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError("nvcc failed on " + ", ".join(failed)
                               + "\n" + "\n".join(log))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run(
            [cc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib)]
            + [str(obj) for _, obj, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        out.with_suffix(".log").write_text("\n".join(log))
        os.replace(tmp_lib, out)  # atomic: concurrent builds agree
    return out


def load():
    """The loaded kernel library (built at first use; once it is loaded,
    no lock is taken)."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
    return _lib


def sass() -> dict:
    """Each kernel's machine code in the built library (``cuobjdump
    --dump-sass``), by mangled function name."""
    tool = Path(nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "--dump-sass", str(build())],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    parts = re.split(r"\n\s*Function : ", text)[1:]
    return {p.split("\n", 1)[0].strip(): p for p in parts}


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if err != 0:
        msg = load().qf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
