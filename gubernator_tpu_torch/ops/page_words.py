"""Wrappers of the page spill and refill kernels of paged state.

Port of `gubernator_tpu/ops/bucket_kernel.py:1596 gather_page_words` and
`:1612 _load_page_words_impl`, the device programs of
`core/paging.py`'s spill and refill:

* `gather_pages(state, starts, page_size)` — kernel K9
  (csrc/page_words.cu `gather_pages_kernel`): the raw words of k pages,
  page i at device row `starts[i]`, as one int32 [k, 12, page_size]
  block (a row per state column, `BucketState` order).
* `load_pages(state, starts, words)` — kernel K10 (`load_pages_kernel`):
  write such a block back into the columns, in place.

The reference moves a page per program; these take the k pages of one
batch's faults in one launch each (core/paging.py).

A CUDA tensor goes to the kernel; a CPU tensor goes to the plain version
(`ops.bucket_kernel.gather_page_words_reference` /
`load_page_words_reference`).  On the card the wrapper checks device,
dtype, shape, contiguity and 16-byte alignment, launches on the current
stream, and raises if the launcher reports a CUDA error; nothing falls
back.  `ops.fused_step.launches["gather_pages"]` / `["load_pages"]`
count the launches.
"""

from __future__ import annotations

import torch

from gubernator_tpu_torch.ops import native_build
from gubernator_tpu_torch.ops.bucket_kernel import (
    PAGE_WORD_ROWS,
    BucketState,
    check_page_starts,
    gather_page_words_reference,
    load_page_words_reference,
)
from gubernator_tpu_torch.ops.fused_step import (
    check_cuda,
    launches,
    state_pointers,
    stream_of,
)


def _check_card(state: BucketState, starts: torch.Tensor, page_size: int, block: torch.Tensor):
    """The kernels' extra terms on the card: 4 | page_size and 16-byte
    aligned column and block pointers (K9 / K10 move 16 bytes a thread).
    Returns (column pointers, capacity)."""
    dev = starts.device
    check_page_starts(state, starts, page_size)
    if page_size % 4:
        raise ValueError(f"page_size must be a multiple of 4 on CUDA; got {page_size}")
    check_cuda(starts, "starts", dev)
    check_cuda(block, "words", dev)
    cols, cap = state_pointers(state, dev)
    for name, col in zip(BucketState._fields, state):
        if col.data_ptr() % 16:
            raise ValueError(f"state.{name} must be 16-byte aligned")
    if block.data_ptr() % 16:
        raise ValueError("the page block must be 16-byte aligned")
    return cols, cap


def gather_pages(state: BucketState, starts: torch.Tensor, page_size: int) -> torch.Tensor:
    """Spill: (state, starts int32 [k]) → int32 [k, 12, page_size], the
    words of the pages at those device rows."""
    dev = starts.device
    if dev.type == "cpu":
        return gather_page_words_reference(state, starts, page_size)
    if dev.type != "cuda":
        raise ValueError(f"gather_pages: unsupported device {dev}")
    check_page_starts(state, starts, page_size)
    k = starts.shape[0]
    out = torch.empty((k, PAGE_WORD_ROWS, page_size), dtype=torch.int32, device=dev)
    cols, cap = _check_card(state, starts, page_size, out)
    lib = native_build.load("page_words")
    with torch.cuda.device(dev):
        rc = lib.guber_gather_pages(cols, cap, starts.data_ptr(), k, page_size, out.data_ptr(),
                                    stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"gather_pages (K9) launch failed: cudaError {rc}")
    launches["gather_pages"] += 1
    return out


def load_pages(state: BucketState, starts: torch.Tensor, words: torch.Tensor) -> None:
    """Refill: write `words` (int32 [k, 12, P]) into the columns at the
    device rows `starts` (int32 [k], pages not overlapping), in place."""
    dev = words.device
    if dev.type == "cpu":
        load_page_words_reference(state, starts, words)
        return
    if dev.type != "cuda":
        raise ValueError(f"load_pages: unsupported device {dev}")
    if words.dtype != torch.int32 or words.dim() != 3 or words.shape[1] != PAGE_WORD_ROWS:
        raise ValueError(f"words must be int32 [k, {PAGE_WORD_ROWS}, P]; got {words.dtype} "
                         f"{list(words.shape)}")
    page_size = words.shape[2]
    cols, cap = _check_card(state, starts, page_size, words)
    k = starts.shape[0]
    if words.shape[0] != k:
        raise ValueError("words and starts disagree on the number of pages")
    lib = native_build.load("page_words")
    with torch.cuda.device(dev):
        rc = lib.guber_load_pages(cols, cap, starts.data_ptr(), k, page_size, words.data_ptr(),
                                  stream_of(dev))
    if rc != 0:
        raise RuntimeError(f"load_pages (K10) launch failed: cudaError {rc}")
    launches["load_pages"] += 1
