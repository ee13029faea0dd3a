"""Build and load the port's native code: the CUDA kernels (csrc/*.cu:
K1 and K4 in fused_step.cu, K2 clear_occupied.cu, K3 collapsed_step.cu,
K5 load_slots.cu, K6 sweep.cu, K7 and K8 sketch.cu) and the host intern
table (csrc/intern_table.cpp).

Each source compiles into its own shared library with a plain C
interface, loaded through `ctypes` (no PyTorch headers, so a build takes
seconds): a `.cu` with `nvcc` for sm_90a, a `.cpp` with
`g++ -O2 -shared -fPIC`.  Libraries land in `csrc/build/` under a name that
carries a hash of the source and the flags, so an edited source builds
anew and an unchanged one is reused.  `build_all()` starts one compiler
per source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module.  `nvcc`
runs only when a kernel is first launched on a CUDA tensor, or when a
caller builds ahead of time; `g++` when the first engine makes its
intern table.
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

# library name → source file under csrc/
SOURCES = {
    "fused_step": "fused_step.cu",
    "clear_occupied": "clear_occupied.cu",
    "collapsed_step": "collapsed_step.cu",
    "load_slots": "load_slots.cu",
    "sweep": "sweep.cu",
    "sketch": "sketch.cu",
    "intern_table": "intern_table.cpp",
}
# Sources a .cu includes: an edit to one rebuilds every kernel.
HEADERS = ("coop_launch.cuh", "lane_math.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

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


def _is_cuda(name: str) -> bool:
    return SOURCES[name].endswith(".cu")


def _compiler(name: str) -> tuple:
    """The command line that builds library `name`, less its output."""
    if _is_cuda(name):
        return (nvcc_path(), *NVCC_FLAGS)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the intern table needs a C++ compiler")
    return (gxx, *GXX_FLAGS)


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    data = src.read_bytes()
    if _is_cuda(name):
        data += b"".join((CSRC / h).read_bytes() for h in HEADERS)
        data += "\0".join(NVCC_FLAGS).encode()
    else:
        data += "\0".join(GXX_FLAGS).encode()
    h = hashlib.sha256(data).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every listed library that is missing, one compiler
    process per source, all started together.  Returns name → library
    path; raises with the compiler's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [*_compiler(n), "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, p) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        build_logs[n] = log
        if p.returncode != 0:
            errors.append(f"build failed for {SOURCES[n]} (rc {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it on first use."""
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
        lib.guber_multi_uniform_step.argtypes = lib.guber_multi_fused_step.argtypes
        lib.guber_multi_uniform_step.restype = i
    elif name == "clear_occupied":
        lib.guber_clear_occupied.argtypes = [p, ctypes.c_longlong, p, i, p]
        lib.guber_clear_occupied.restype = i
    elif name == "collapsed_step":
        lib.guber_collapsed_step.argtypes = [
            ctypes.POINTER(p), ctypes.c_longlong, p, i, p, i, p, ctypes.c_longlong,
            ctypes.c_longlong, p, p
        ]
        lib.guber_collapsed_step.restype = i
        lib.guber_collapsed_threads.argtypes = []
        lib.guber_collapsed_threads.restype = i
    elif name == "load_slots":
        lib.guber_load_slots.argtypes = [ctypes.POINTER(p), ctypes.c_longlong, p, i, p]
        lib.guber_load_slots.restype = i
    elif name == "sweep":
        ll = ctypes.c_longlong
        lib.guber_sweep_scratch_words.argtypes = [ll]
        lib.guber_sweep_scratch_words.restype = ll
        lib.guber_sweep_window.argtypes = [p, p, p, ll, ll, ll, p, p, p]
        lib.guber_sweep_window.restype = i
    elif name == "sketch":
        ll = ctypes.c_longlong
        # counts, depth, width, pin, size, cur, out, row_est scratch, stream
        lib.guber_sketch_step.argtypes = [p, i, ll, p, i, i, p, p, p]
        lib.guber_sketch_step.restype = i
        lib.guber_sketch_rotate.argtypes = [p, ll, p]
        lib.guber_sketch_rotate.restype = i
    elif name == "intern_table":
        i64 = ctypes.c_int64
        lib.git_new.restype = p
        lib.git_new.argtypes = [i64]
        lib.git_free.argtypes = [p]
        lib.git_len.restype = i64
        lib.git_len.argtypes = [p]
        # table, buf, offsets, idx (nullable), n, now_ms, out_slots,
        # out_rounds, out_evicted, out_evict_rounds, stats_out
        lib.git_schedule_idx.restype = i64
        lib.git_schedule_idx.argtypes = [p, p, p, p, i64, i64, p, p, p, p, p]
        lib.git_set_expiry.argtypes = [p, p, p, i64]
        lib.git_remove.restype = ctypes.c_int32
        lib.git_remove.argtypes = [p, ctypes.c_char_p, i64]
        lib.git_release.argtypes = [p, p, i64]
        lib.git_key_for_slot.restype = i64
        lib.git_key_for_slot.argtypes = [p, ctypes.c_int32, p, i64]
        lib.git_contains.restype = i64
        lib.git_contains.argtypes = [p, ctypes.c_char_p, i64]
