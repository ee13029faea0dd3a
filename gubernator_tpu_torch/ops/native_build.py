"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source compiles with `nvcc` into its own shared library with a
plain C interface, loaded through `ctypes` (no PyTorch headers, so a
build takes seconds).  Libraries land in `csrc/build/` under a name that
carries a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.  `build_all()` starts one `nvcc`
per source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module.  `nvcc`
runs only when a kernel is first launched on a CUDA tensor, or when a
caller builds ahead of time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

# kernel name → source file under csrc/
SOURCES = {
    "fused_step": "fused_step.cu",
    "clear_occupied": "clear_occupied.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, spills) of each library built in this process.
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc,
    or `nvcc` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + "\0".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every listed kernel whose library is missing, one `nvcc`
    process per source, all started together.  Returns name → library
    path; raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, p) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        build_logs[n] = log
        if p.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[n]} (rc {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name])[name]))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p = ctypes.c_void_p
    i = ctypes.c_int
    if name == "fused_step":
        lib.guber_multi_fused_step.argtypes = [
            ctypes.POINTER(p), ctypes.c_longlong, p, i, p, i, p, p, i, p, i, p
        ]
        lib.guber_multi_fused_step.restype = i
    elif name == "clear_occupied":
        lib.guber_clear_occupied.argtypes = [p, ctypes.c_longlong, p, i, p]
        lib.guber_clear_occupied.restype = i
