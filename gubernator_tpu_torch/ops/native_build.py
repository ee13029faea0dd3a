"""Build and load the port's native code: the CUDA kernels (csrc/*.cu:
K1 and K4 in fused_step.cu, K2 clear_occupied.cu, K3 collapsed_step.cu,
K5 load_slots.cu, K6 and K13 sweep.cu, K7 and K8 sketch.cu, K9 and K10
page_words.cu, K11 and K12 sharded_step.cu, K14-K16 split_step.cu, K17
apply_batch.cu), the
host intern table (csrc/intern_table.cpp), the wire codec (csrc/wire_codec.cpp), the
h2 front (csrc/h2_server.cpp, linked with the wire codec, the native
decision plane, csrc/decision_plane.cpp, the columnar feeder,
csrc/columnar_feeder.cpp, and the event ring, csrc/event_ring.cpp, into
one library, as the reference's `_EXTRA_SOURCES` does) and the h2 load
client
(csrc/h2_client.cpp).

Each library has a plain C interface, loaded through `ctypes` (no
PyTorch headers, so a build takes seconds): a `.cu` with `nvcc` for
sm_90a, `.cpp` sources with `g++ -O2 -shared -fPIC -pthread`.  Libraries
land in `csrc/build/` under a name that carries a hash of every source
of the library and the flags, so an edited source builds anew and an
unchanged one is reused.  `build_all()` starts one compiler per library
at once and waits for all of them.  `load` declares the argument and
result types of every export.

Nothing here runs at import: the CPU tests import every module.  `nvcc`
runs only when a kernel is first launched on a CUDA tensor, or when a
caller builds ahead of time; `g++` when the first engine makes its
intern table.

Sanitizer builds (reference `gubernator_tpu/core/native_build.py`
`san_mode`, `sanitizer_preload`): GUBER_NATIVE_SAN=thread (or 1, tsan)
or address (asan) builds the `g++` libraries with `-O1 -g
-fno-omit-frame-pointer -fsanitize=<mode>` in place of `-O2`, under a
name of their own (the flags are hashed, and the name ends in `-tsan` or
`-asan`), so a sanitized library never replaces a plain one; the `.cu`
libraries build as always.  A sanitizer runtime cannot start inside a
Python that is already running uninstrumented, so a sanitized library is
loaded only in a child process that has the runtime in LD_PRELOAD
(`sanitizer_preload` finds it); `load` refuses it anywhere else.  A
parent builds for such a child with `build_all(names, san=mode)`, which
leaves its own environment as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

_log = logging.getLogger("gubernator_tpu_torch.native")

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

# library name → its source files under csrc/
SOURCES = {
    "fused_step": ("fused_step.cu",),
    "clear_occupied": ("clear_occupied.cu",),
    "collapsed_step": ("collapsed_step.cu",),
    "load_slots": ("load_slots.cu",),
    "sweep": ("sweep.cu",),
    "sketch": ("sketch.cu",),
    "page_words": ("page_words.cu",),
    "sharded_step": ("sharded_step.cu",),
    "split_step": ("split_step.cu",),
    "apply_batch": ("apply_batch.cu",),
    "intern_table": ("intern_table.cpp",),
    "wire_codec": ("wire_codec.cpp",),
    # The wire codec, the decision plane, the columnar feeder and the event
    # ring link into the h2 server, as the reference's do: the plane
    # answers hot-key RPCs and the feeder packs the others into column
    # windows, both in the server's own threads, which publish their
    # stages' latencies into the ring.
    "h2_server": ("h2_server.cpp", "wire_codec.cpp", "decision_plane.cpp",
                  "columnar_feeder.cpp", "event_ring.cpp"),
    "h2_client": ("h2_client.cpp",),
}
# Sources a .cu includes: an edit to one rebuilds every kernel.
HEADERS = ("coop_launch.cuh", "lane_math.cuh", "general_lane.cuh", "collapsed_tile.cuh")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
# -pthread: the h2 server and client run threads of their own.
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC", "-pthread")
# A sanitized build keeps frames and symbols and optimises less, so that
# its reports carry usable stacks.
SAN_FLAGS = ("-O1", "-g", "-fno-omit-frame-pointer")
# mode → (the runtime's library, a symbol that only the runtime defines)
_SAN_RUNTIMES = {"thread": ("libtsan.so", "__tsan_init"),
                 "address": ("libasan.so", "__asan_init")}

# The h2 front's window callback (csrc/h2_server.cpp WindowCallback):
# (concat bodies, len, item_counts [n_rpcs], body_lens [n_rpcs], n_rpcs,
# total_items, out_cols [4 * total], out_rpc_status [n_rpcs]) → 0 or a
# grpc status that fails the whole window.
WINDOW_CALLBACK = ctypes.CFUNCTYPE(
    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
)

# The columnar feeder's window callback (csrc/columnar_feeder.cpp
# ColumnarCallback): (slot, n_rows, n_rpcs, key_bytes) → 0 or a grpc
# status that fails the whole window.
FEEDER_CALLBACK = ctypes.CFUNCTYPE(
    ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
)

_lock = threading.Lock()
_libs: dict[tuple, ctypes.CDLL] = {}
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


def san_mode() -> str:
    """'' (off), 'thread' or 'address', from GUBER_NATIVE_SAN."""
    v = os.environ.get("GUBER_NATIVE_SAN", "").strip().lower()
    if v in ("", "0", "off", "none"):
        return ""
    if v in ("1", "thread", "tsan"):
        return "thread"
    if v in ("address", "asan"):
        return "address"
    _log.warning("GUBER_NATIVE_SAN=%r not recognized; sanitizer off", v)
    return ""


def sanitizer_preload(mode: Optional[str] = None) -> Optional[str]:
    """Path of the sanitizer runtime to LD_PRELOAD into a child process
    that loads a sanitized library (`g++ -print-file-name`), or None when
    the toolchain has none.  `mode` None reads GUBER_NATIVE_SAN."""
    mode = san_mode() if mode is None else mode
    if not mode:
        return None
    lib = _SAN_RUNTIMES[mode][0]
    try:
        out = subprocess.run(["g++", f"-print-file-name={lib}"], capture_output=True, text=True,
                             timeout=10, check=True).stdout.strip()
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired, OSError):
        return None
    return out if out and os.path.sep in out and Path(out).exists() else None


def _is_cuda(name: str) -> bool:
    return SOURCES[name][0].endswith(".cu")


def _lib_san(name: str, san: str) -> str:
    """The sanitizer a build of `name` takes: none for a `.cu` library."""
    return "" if _is_cuda(name) else san


def _gxx_flags(san: str) -> tuple:
    if not san:
        return GXX_FLAGS
    return (*(f for f in GXX_FLAGS if f != "-O2"), *SAN_FLAGS, f"-fsanitize={san}")


def _compiler(name: str) -> tuple:
    """The command line that builds library `name`, less its output."""
    if _is_cuda(name):
        return (nvcc_path(), *NVCC_FLAGS)
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {name} needs a C++ compiler")
    return (gxx, *GXX_FLAGS)


def _target(name: str, san: str = "") -> Path:
    san = _lib_san(name, san)
    data = "\0".join(SOURCES[name]).encode()
    data += b"".join((CSRC / src).read_bytes() for src in SOURCES[name])
    if _is_cuda(name):
        data += b"".join((CSRC / h).read_bytes() for h in HEADERS)
        data += "\0".join(NVCC_FLAGS).encode()
    else:
        data += "\0".join(_gxx_flags(san)).encode()
    h = hashlib.sha256(data).hexdigest()
    return BUILD_DIR / f"lib{name}-{h[:16]}{f'-{san[0]}san' if san else ''}.so"


def build_all(names=None, san: Optional[str] = None) -> dict[str, Path]:
    """Compile every listed library that is missing, one compiler
    process per library, all started together.  Returns name → library
    path; raises with the compiler's output if any build fails.  `san`
    ('', 'thread' or 'address') builds the `g++` libraries sanitized;
    None reads GUBER_NATIVE_SAN."""
    names = list(SOURCES) if names is None else list(names)
    san = san_mode() if san is None else san
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = {n: _target(n, san) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}")
        cmd = _compiler(n)
        if _lib_san(n, san):
            cmd = (cmd[0], *_gxx_flags(san))
        cmd = [*cmd, "-o", str(tmp), *(str(CSRC / src) for src in SOURCES[n])]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, p) in procs.items():
        log = p.communicate()[0].decode(errors="replace")
        build_logs[n] = log
        if p.returncode != 0:
            errors.append(f"build failed for {' + '.join(SOURCES[n])} (rc {p.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def _runtime_loaded(san: str) -> bool:
    """Whether this process runs the sanitizer's runtime (preloaded: its
    symbols are in the global scope)."""
    return hasattr(ctypes.CDLL(None), _SAN_RUNTIMES[san][1])


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building it on first use; sanitized
    when GUBER_NATIVE_SAN asks for it, which only a process with the
    sanitizer's runtime preloaded may do."""
    san = _lib_san(name, san_mode())
    if san and not _runtime_loaded(san):
        raise RuntimeError(
            f"GUBER_NATIVE_SAN={san}: the sanitized {name} library loads only in a process "
            f"started with LD_PRELOAD={sanitizer_preload(san) or _SAN_RUNTIMES[san][0]}")
    with _lock:
        lib = _libs.get((name, san))
        if lib is None:
            lib = ctypes.CDLL(str(build_all([name], san)[name]))
            _declare(name, lib)
            _libs[(name, san)] = lib
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
    elif name == "split_step":
        ll = ctypes.c_longlong
        # cols, cap, pin, width, words, pout, stream
        lib.guber_packed_compute.argtypes = [ctypes.POINTER(p), ll, p, i, p, p, p]
        lib.guber_packed_compute.restype = i
        # cols, cap, slot, words, width, stream
        lib.guber_scatter_store.argtypes = [ctypes.POINTER(p), ll, p, p, i, p]
        lib.guber_scatter_store.restype = i
        # cols, cap, pin, width, pub, pub_tiles, tiles_before, words, pout, stream
        lib.guber_collapsed_compute.argtypes = [ctypes.POINTER(p), ll, p, i, p, ll, ll, p, p, p]
        lib.guber_collapsed_compute.restype = i
        lib.guber_collapsed_compute_threads.argtypes = []
        lib.guber_collapsed_compute_threads.restype = i
    elif name == "apply_batch":
        # cols, cap, in_cols[9], width, clear_slots, n_clear, now_ms, out_cols[4], stream
        lib.guber_apply_batch.argtypes = [ctypes.POINTER(p), ctypes.c_longlong, ctypes.POINTER(p),
                                          i, p, i, ctypes.c_longlong, ctypes.POINTER(p), p]
        lib.guber_apply_batch.restype = i
    elif name == "sweep":
        ll = ctypes.c_longlong
        lib.guber_sweep_tile_slots.argtypes = []
        lib.guber_sweep_tile_slots.restype = i
        # meta, hi2, expire_lo, n_sh, stride, n_windows, starts, own_lo,
        # own_hi, window, tiles_per_row, quads, vec, now_ms, pub,
        # tiles_before, stamp, silent_tile, out, stream
        lib.guber_sweep_windows.argtypes = [
            p, p, p, i, ll, i, ctypes.POINTER(ll), ctypes.POINTER(i), ctypes.POINTER(i), ll, ll,
            i, i, ll, p, ctypes.c_ulonglong, ctypes.c_uint, ll, p, p
        ]
        lib.guber_sweep_windows.restype = i
    elif name == "sharded_step":
        ll = ctypes.c_longlong
        # cols, shard_cap, n_sh, pin, width, round_off, n_rounds, clear_off,
        # clear_slots, n_clear, widest, pout, stream
        lib.guber_shard_step.argtypes = [ctypes.POINTER(p), ll, i, p, i, p, i, p, p, i, i, p, p]
        lib.guber_shard_step.restype = i
        # ..., n_clear, pub, pub_tiles, tiles_before, pout, stream
        lib.guber_shard_collapsed.argtypes = [ctypes.POINTER(p), ll, i, p, i, p, i, p, ll, ll,
                                              p, p]
        lib.guber_shard_collapsed.restype = i
        lib.guber_shard_collapsed_threads.argtypes = []
        lib.guber_shard_collapsed_threads.restype = i
    elif name == "sketch":
        ll = ctypes.c_longlong
        # counts, depth, width, pin, size, cur, out, row_est scratch, then the
        # plan: form, threads, shared_bytes; stream
        lib.guber_sketch_step.argtypes = [p, i, ll, p, i, i, p, p, i, i, i, p]
        lib.guber_sketch_step.restype = i
        lib.guber_sketch_rotate.argtypes = [p, ll, p]
        lib.guber_sketch_rotate.restype = i
    elif name == "page_words":
        # cols, cap, starts, k, page, out / words, stream
        for fn in (lib.guber_gather_pages, lib.guber_load_pages):
            fn.argtypes = [ctypes.POINTER(p), ctypes.c_longlong, p, i, i, p, p]
            fn.restype = i
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
        # tables (void*[n_sh]), n_sh, buf, offsets, hashes (nullable), n,
        # now_ms, expires (nullable), out_shard, out_slots, out_rounds,
        # out_order, out_shard_counts, out_evicted, out_evict_shard,
        # out_evict_rounds, out_n_evicted, stats_out, n_threads
        lib.git_multi_schedule.restype = i64
        lib.git_multi_schedule.argtypes = [p, i64, p, p, p, i64, i64, p] + [p] * 10 + [i64]
        lib.git_set_expiry.argtypes = [p, p, p, i64]
        lib.git_remove.restype = ctypes.c_int32
        lib.git_remove.argtypes = [p, ctypes.c_char_p, i64]
        lib.git_release.argtypes = [p, p, i64]
        lib.git_key_for_slot.restype = i64
        lib.git_key_for_slot.argtypes = [p, ctypes.c_int32, p, i64]
        lib.git_contains.restype = i64
        lib.git_contains.argtypes = [p, ctypes.c_char_p, i64]
    if name in ("wire_codec", "h2_server"):
        i64 = ctypes.c_int64
        # buf, len, max_items, disqualify_mask, key_buf, key_cap, then
        # key_offsets, algo, behavior, hits, limit, duration, burst, fnv1,
        # fnv1a, name_lens
        lib.wire_decode_reqs.restype = i64
        lib.wire_decode_reqs.argtypes = [ctypes.c_char_p, i64, i64, i64, p, i64] + [p] * 10
        # status, limit, remaining, reset_time, n, out, out_cap
        lib.wire_encode_resps.restype = i64
        lib.wire_encode_resps.argtypes = [p, p, p, p, i64, p, i64]
        # status, limit, remaining, reset_time, n, over_status, now_ms,
        # out, out_cap
        lib.wire_encode_resps_hint.restype = i64
        lib.wire_encode_resps_hint.argtypes = [p, p, p, p, i64, ctypes.c_int32, i64, p, i64]
    if name == "h2_server":
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        # port, window_us, max_batch, flush_items, lanes, event_front,
        # reactors, idle_timeout_ms, callback
        lib.h2s_start.restype = p
        lib.h2s_start.argtypes = [i32, i64, i64, i64, i32, i32, i32, i64, WINDOW_CALLBACK]
        for fn in (lib.h2s_port, lib.h2s_lanes, lib.h2s_reactors):
            fn.restype = i32
            fn.argtypes = [p]
        lib.h2s_stats.restype = None
        lib.h2s_stats.argtypes = [p, p]
        lib.h2s_stop.restype = None
        lib.h2s_stop.argtypes = [p]
        lib.h2s_attach_plane.restype = None
        lib.h2s_attach_plane.argtypes = [p, p]
        # The native decision plane (csrc/decision_plane.cpp).
        # max_keys, token_algo, breakers_mask, disqualify_mask,
        # over_status, under_status
        lib.dp_create.restype = p
        lib.dp_create.argtypes = [i64, i64, i64, i64, i32, i32]
        lib.dp_free.restype = None
        lib.dp_free.argtypes = [p]
        for fn in (lib.dp_set_clock_offset, lib.dp_set_hints):
            fn.restype = None
            fn.argtypes = [p, i64]
        # plane, key, klen, limit, duration, reset
        lib.dp_install_over.restype = i64
        lib.dp_install_over.argtypes = [p, ctypes.c_char_p, i64, i64, i64, i64]
        # ..., rem, credit, consumed, expiry
        lib.dp_install_lease.restype = i64
        lib.dp_install_lease.argtypes = [p, ctypes.c_char_p, i64, i64, i64, i64, i64, i64, i64,
                                         i64]
        for fn in (lib.dp_pull, lib.dp_peek):  # plane, key, klen, out4
            fn.restype = i64
            fn.argtypes = [p, ctypes.c_char_p, i64, p]
        lib.dp_clear.restype = None
        lib.dp_clear.argtypes = [p]
        # plane, key, klen, algo, behavior, hits, limit, duration, now_ms,
        # out3
        lib.dp_probe.restype = i64
        lib.dp_probe.argtypes = [p, ctypes.c_char_p, i64, i32, i32, i64, i64, i64, i64, p]
        # plane, body, len, max_items, now_ms (-1 = the plane's clock),
        # out, out_cap
        lib.dp_try_serve.restype = i64
        lib.dp_try_serve.argtypes = [p, ctypes.c_char_p, i64, i64, i64, p, i64]
        lib.dp_stats.restype = None
        lib.dp_stats.argtypes = [p, p]
        # The columnar feeder (csrc/columnar_feeder.cpp).
        # n_slots, max_rows, key_cap, max_rpcs, disqualify_mask, window_us,
        # flush_rows, over_status, callback
        lib.cf_create.restype = p
        lib.cf_create.argtypes = [i64, i64, i64, i64, i64, i64, i64, i32, FEEDER_CALLBACK]
        lib.cf_set_hints.restype = None
        lib.cf_set_hints.argtypes = [p, i64]
        lib.cf_slot_ptrs.restype = None  # feeder, slot, out19
        lib.cf_slot_ptrs.argtypes = [p, i64, p]
        # feeder, body, len, max_items, conn_token, stream, t_enq_ns
        lib.cf_pack.restype = i64
        lib.cf_pack.argtypes = [p, p, i64, i64, p, i64, i64]
        for fn in (lib.cf_flush, lib.cf_stop, lib.cf_free):
            fn.restype = None
            fn.argtypes = [p]
        lib.cf_stats.restype = None  # feeder, out13
        lib.cf_stats.argtypes = [p, p]
        # feeder, body, len, max_items, reps, threads
        lib.cf_bench_pack.restype = i64
        lib.cf_bench_pack.argtypes = [p, p, i64, i64, i64, i64]
        lib.h2s_attach_feeder.restype = None
        lib.h2s_attach_feeder.argtypes = [p, p]
        # conn_token, stream, payload, len, grpc_status
        lib.h2s_feeder_respond.restype = None
        lib.h2s_feeder_respond.argtypes = [p, i64, p, i64, i32]
        lib.h2s_feeder_release.restype = None
        lib.h2s_feeder_release.argtypes = [p]
        # The event ring (csrc/event_ring.cpp) and its attach points.
        for fn in (lib.h2s_attach_ring, lib.cf_attach_ring):
            fn.restype = None
            fn.argtypes = [p, p]
        lib.evr_create.restype = p
        lib.evr_create.argtypes = [i64]
        lib.evr_free.restype = None
        lib.evr_free.argtypes = [p]
        # ring, out (4 int64 a record), max_records
        lib.evr_drain.restype = i64
        lib.evr_drain.argtypes = [p, p, i64]
        lib.evr_stats.restype = None  # ring, out2
        lib.evr_stats.argtypes = [p, p]
        # ring, kind, t_end_ns, dur_ns, items
        lib.evr_record.restype = i64
        lib.evr_record.argtypes = [p, i64, i64, i64, i64]
        lib.evr_now_ns.restype = i64
        lib.evr_now_ns.argtypes = []
    elif name == "h2_client":
        i32, i64, f64, s = ctypes.c_int32, ctypes.c_int64, ctypes.c_double, ctypes.c_char_p
        # host, port, path, authority, payload, payload_len, seconds,
        # n_conns, out_lats, max_lats, out_stats, out_resp, resp_cap,
        # out_resp_len
        lib.h2_bench_unary.restype = i64
        lib.h2_bench_unary.argtypes = [s, i32, s, s, p, i64, f64, i32, p, i64, p, p, i64, p]
        # host, port, path, authority, payload, payload_len, seconds,
        # n_conns, n_active, threads, ramp_budget_s, out_lats, max_lats,
        # out_stats
        lib.h2_connscale_run.restype = i64
        lib.h2_connscale_run.argtypes = [s, i32, s, s, p, i64, f64, i64, i64, i32, f64, p, i64, p]
