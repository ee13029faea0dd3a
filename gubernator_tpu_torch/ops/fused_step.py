"""Wrappers of the port's round kernels, with the launch counts of all
the port's kernels.

Port of `gubernator_tpu/ops/pallas_step.py` (`pallas_fused_step` :158),
of its multi-round form (`bucket_kernel.py:1088 multi_fused_step`), of
the uniform format (`bucket_kernel.py:1161 uniform_step`, :1198
`multi_uniform_step`) and of the eviction clear (`bucket_kernel.py:329
_clear_occupied_impl`):

* `multi_fused_step(state, pin, round_off, clear_off, clear_slots)` —
  kernel K1 (csrc/fused_step.cu): R packed rounds, each after its
  eviction clears, in one cooperative launch with a grid barrier between
  rounds; state updated in place, returns the [5, L] int32 output.
* `fused_step(state, pin)` — the same kernel over one round (R = 1, no
  clears).
* `multi_uniform_step(state, pin, round_off, clear_off, clear_slots)` —
  kernel K4 (csrc/fused_step.cu `slot_range_kernel`): the uniform format,
  pin [2, L], returns the narrow [2, L] output; one plain launch in which
  each block owns a fixed slot range in every round, so rounds need no
  grid barrier.
* `clear_occupied(meta, slots)` — kernel K2 (csrc/clear_occupied.cu):
  clear the occupied bit at evicted slots, in place.  The serving path
  runs its clears inside K1, K3 and K4; the engine launches K2 where a
  clear must run on its own: before a store restore in the same round,
  for the evictions of `load`, and for each round's clears under the
  split arm.
* `load_slots(state, rec)` — kernel K5 (csrc/load_slots.cu), the port
  of `bucket_kernel.py:1526 _load_slots_impl`: write the state words of
  restored items (record layout `ops.bucket_kernel.RESTORE_FIELDS`) at
  their slots, in place.

K3, the collapsed step, has its wrapper in `ops.collapsed_step`, K6 and
K13, the expiry sweep of one state and of every shard, in `ops.expiry`,
K7 / K8, the count-min sketch's step and rotation, in `ops.sketch`,
K9 / K10, the page spill and refill, in `ops.page_words`, K11 / K12,
the sharded engine's per-shard steps, in `ops.sharded_step`, and K14-K16,
the split arm's compute and scatter kernels, in `ops.split_step`, and
K17, the dataclass step, in `ops.apply_batch`; their
launches count here too (K14-K16's in `split_launches`).

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain
PyTorch version in `ops.bucket_kernel`; any other device raises.  There
is no fallback from a failed launch: the wrapper checks device, dtype,
shape and contiguity, launches on the current stream, and raises if the
launcher reports a CUDA error (a refused launch included).
`launches[name]` and `split_launches[name]` count kernel launches (and
only those), so a run can show that its path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import (
    PACKED_OUT_ROWS,
    PACKED_IN_ROWS,
    UNIFORM_IN_ROWS,
    UNIFORM_OUT_ROWS,
    BucketState,
    check_pin,
    check_restore,
    check_rounds,
    check_state,
    clear_occupied_reference,
    fused_step_reference,
    load_slots_reference,
    multi_fused_step_reference,
    multi_uniform_step_reference,
)

# Kernel launches since the last reset_launches(), by kernel name.
launches = {"fused_step": 0, "clear_occupied": 0, "collapsed_step": 0, "uniform_step": 0,
            "load_slots": 0, "sweep_window": 0, "sketch_step": 0, "sketch_rotate": 0,
            "gather_pages": 0, "load_pages": 0, "shard_step": 0, "shard_collapsed": 0,
            "shard_sweep": 0, "apply_batch": 0}
# Launches of the split arm's kernels (K14-K16, `ops.split_step`), counted
# apart from `launches`, whose sum on a path of the fused arm is that
# path's engine and sweep launches.
split_launches = {"packed_compute": 0, "scatter_store": 0, "collapsed_compute": 0}
# Calls of a kernel that has more than one form, by the form each call
# took (K7: "block", one device launch; "pair", two), since the last
# reset_launches().
forms = {"sketch_step": {"block": 0, "pair": 0}}


def reset_launches() -> None:
    for counts in (launches, split_launches):
        for k in counts:
            counts[k] = 0
    for by_form in forms.values():
        for k in by_form:
            by_form[k] = 0


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller asks
    for another (the tests pass "cpu").  Raises when CUDA is wanted but
    absent — the port never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def stream_of(dev: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check_cuda(t: torch.Tensor, what: str, dev: torch.device) -> None:
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, expected {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def state_pointers(state: BucketState, dev: torch.device):
    """The 12 columns' device pointers, as the kernels take them; checks
    the state's shape, dtype and device.  Returns (pointers, cap)."""
    cap = check_state(state)
    for name, col in zip(BucketState._fields, state):
        check_cuda(col, f"state.{name}", dev)
    return (ctypes.c_void_p * len(state))(*(c.data_ptr() for c in state)), cap


def fused_step(state: BucketState, pin: torch.Tensor) -> torch.Tensor:
    """One packed round: (state, pin int32 [16, W]) → pout int32 [5, W];
    `state` is updated in place.  On CUDA it is K1's R = 1 call: one
    round over all W lanes, no clears."""
    dev = pin.device
    if dev.type == "cpu":
        return fused_step_reference(state, pin)
    if dev.type != "cuda":
        raise ValueError(f"fused_step: unsupported device {dev}")
    check_pin(pin)
    width = pin.shape[1]
    # round_off [0, W], clear_off [0, 0], clear_slots [0] (never read),
    # filled on the device: no host copy
    offs = torch.zeros(5, dtype=torch.int32, device=dev)
    offs[1] = width
    return _launch_rounds("fused_step", state, pin, offs[:2], 1, offs[2:4], offs[4:], width)


def multi_fused_step(
    state: BucketState,
    pin: torch.Tensor,
    round_off: torch.Tensor,
    clear_off: torch.Tensor,
    clear_slots: torch.Tensor,
    *,
    widest: int | None = None,
) -> torch.Tensor:
    """R rounds in order, each after its clears: (state, pin int32
    [16, L], round_off int32 [R+1], clear_off int32 [R+1], clear_slots
    int32 [C ≥ 1]) → pout int32 [5, L]; `state` is updated in place.
    Layout as `ops.bucket_kernel.PackedRounds`.  On CUDA, `widest` (the
    widest round's lanes, `PackedRounds.widest`) sizes K1's grid and must
    be given; the plain version does not need it."""
    dev = pin.device
    if dev.type == "cpu":
        return multi_fused_step_reference(state, pin, round_off, clear_off, clear_slots)
    return _multi_rounds("fused_step", state, pin, round_off, clear_off, clear_slots, widest)


def multi_uniform_step(
    state: BucketState,
    pin: torch.Tensor,
    round_off: torch.Tensor,
    clear_off: torch.Tensor,
    clear_slots: torch.Tensor,
    *,
    widest: int | None = None,
) -> torch.Tensor:
    """R uniform rounds in order, each after its clears: (state, pin
    int32 [2, L] laid out as `ops.bucket_kernel.pack_uniform_rounds_host`,
    round_off, clear_off, clear_slots) → pout int32 [2, L]; `state` is
    updated in place.  On CUDA it is kernel K4, and `widest` must be
    given, as for `multi_fused_step`."""
    dev = pin.device
    if dev.type == "cpu":
        return multi_uniform_step_reference(state, pin, round_off, clear_off, clear_slots)
    return _multi_rounds("uniform_step", state, pin, round_off, clear_off, clear_slots, widest)


# kernel name → (pin rows, pout rows, C entry point, label)
_ROUND_KERNELS = {
    "fused_step": (PACKED_IN_ROWS, PACKED_OUT_ROWS, "guber_multi_fused_step", "K1"),
    "uniform_step": (UNIFORM_IN_ROWS, UNIFORM_OUT_ROWS, "guber_multi_uniform_step", "K4"),
}


def _multi_rounds(kernel, state, pin, round_off, clear_off, clear_slots, widest):
    dev = pin.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {dev}")
    n_rounds = check_rounds(pin, round_off, clear_off, clear_slots, _ROUND_KERNELS[kernel][0])
    for name, t in (("round_off", round_off), ("clear_off", clear_off),
                    ("clear_slots", clear_slots)):
        check_cuda(t, name, dev)
    if widest is None:
        raise ValueError(f"{kernel} on CUDA needs `widest` to size its grid")
    return _launch_rounds(kernel, state, pin, round_off, n_rounds, clear_off, clear_slots,
                          widest)


def _launch_rounds(kernel, state, pin, round_off, n_rounds, clear_off, clear_slots,
                   widest) -> torch.Tensor:
    """Launch K1 or K4 over the R rounds of `pin` (offsets and clears on
    the device)."""
    in_rows, out_rows, entry, label = _ROUND_KERNELS[kernel]
    dev = pin.device
    check_pin(pin, in_rows)
    check_cuda(pin, "pin", dev)
    cols, cap = state_pointers(state, dev)
    width = pin.shape[1]
    if width < 1:
        raise ValueError(f"{kernel}: empty pin")
    lib = native_build.load("fused_step")
    pout = torch.empty((out_rows, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(
            cols, cap, pin.data_ptr(), width, round_off.data_ptr(), n_rounds,
            clear_off.data_ptr(), clear_slots.data_ptr(), clear_slots.shape[0],
            pout.data_ptr(), max(int(widest), 1), stream_of(dev),
        )
    if rc != 0:
        raise RuntimeError(f"{kernel} ({label}) launch failed: cudaError {rc}")
    launches[kernel] += 1
    return pout


def clear_occupied(meta: torch.Tensor, slots: torch.Tensor) -> None:
    """Clear the occupied bit of `meta` (int32 [cap]) at each unique
    slot of `slots` (int32 [n]) in [0, cap), in place."""
    dev = meta.device
    if dev.type == "cpu":
        if slots.device != dev:
            raise ValueError(f"slots is on {slots.device}, meta on {dev}")
        clear_occupied_reference(meta, slots)
        return
    if dev.type != "cuda":
        raise ValueError(f"clear_occupied: unsupported device {dev}")
    if meta.dtype != torch.int32 or meta.dim() != 1:
        raise ValueError("meta must be int32 [cap]")
    if slots.dtype != torch.int32 or slots.dim() != 1 or slots.shape[0] < 1:
        raise ValueError("slots must be int32 [n], n >= 1")
    check_cuda(meta, "meta", dev)
    check_cuda(slots, "slots", dev)
    lib = native_build.load("clear_occupied")
    with torch.cuda.device(dev):
        rc = lib.guber_clear_occupied(
            meta.data_ptr(), meta.shape[0], slots.data_ptr(), slots.shape[0], stream_of(dev)
        )
    if rc != 0:
        raise RuntimeError(f"clear_occupied kernel launch failed: cudaError {rc}")
    launches["clear_occupied"] += 1


def load_slots(state: BucketState, rec: torch.Tensor) -> None:
    """Restore: write the 12 state words of each lane of `rec` (int32
    [RESTORE_ROWS, n], `ops.bucket_kernel.pack_restore_host`) at its slot,
    in place; slots sorted and unique, lanes outside [0, cap) dropped."""
    dev = rec.device
    if dev.type == "cpu":
        load_slots_reference(state, rec)
        return
    if dev.type != "cuda":
        raise ValueError(f"load_slots: unsupported device {dev}")
    check_restore(rec)
    check_cuda(rec, "rec", dev)
    cols, cap = state_pointers(state, dev)
    lib = native_build.load("load_slots")
    with torch.cuda.device(dev):
        rc = lib.guber_load_slots(cols, cap, rec.data_ptr(), rec.shape[1], stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"load_slots (K5) launch failed: cudaError {rc}")
    launches["load_slots"] += 1
