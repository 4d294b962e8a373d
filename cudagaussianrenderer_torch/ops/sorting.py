"""Tile-list sort — stage D of the frame pipeline.

The reference sorts (key, splat-index) pairs with cub::DeviceRadixSort
(sortTileList, GaussianRender.cu:804-855); the JAX package leaves its
variadic sort to XLA.  The port takes one of two paths, chosen by
``sort_path`` from what it can see in its input:

* ``kernel``: the packed key (one uint32 word, ``tile << 19 | depth19``)
  on the card.  ``sort_words`` (csrc/sort.cu) sorts the word as 32 bits
  with the int32 slot index as its payload, cub's radix sort in 4 passes
  of 16 B a slot, and gathers the attribute words (and the splat indices)
  by the sorted slots into one [3 or 4, C] tensor.
* ``torch``: the two-word key (``depth_bits=32``), and every CPU tensor.
  ONE int64 key is sorted with ``torch.sort`` and the values and the three
  attribute words are gathered by the returned permutation.  For the
  packed key the int64 is the uint32 key; for the two words it is
  ``tile << 32 | depth << 8``, which orders exactly like the
  lexicographic (tile, depth) pair, sentinels included.  This path is the
  kernel path's oracle in the tests.

Invalid entries carry sentinel keys and land in a dead suffix that the
ranges stage never addresses.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from ..utils import cuda_build as cb
from .binning import TilePairs
from .geometry import as_i32, as_u32_i64

SORT_PATHS = ("torch", "kernel")


def sort_path(device_type: str, key_words: int) -> str:
    """The path sort_pairs takes for a key of ``key_words`` int32 words on
    a device of type ``device_type``: ``kernel`` for the packed key on the
    card, ``torch`` otherwise."""
    return "kernel" if device_type == "cuda" and key_words == 1 else "torch"


@functools.lru_cache(maxsize=None)
def _temp_bytes(n: int, device_index: int) -> int:
    """cub's temporary storage for sorting n pairs on a device (asked once;
    the query runs nothing on the device)."""
    fn = cb.kernel("sort", "gsr_sort_temp_bytes", [cb.I64, ctypes.POINTER(ctypes.c_size_t)])
    with torch.cuda.device(device_index):
        out = ctypes.c_size_t()
        cb.check("sort", fn(n, ctypes.byref(out)))
    return max(int(out.value), 1)


def _sort_words_torch(key: torch.Tensor, words: Sequence[torch.Tensor]):
    """Plain PyTorch version of sort_words: the stable torch.sort of the key
    widened to int64, then a gather of each word by its permutation."""
    sorted_key, perm = torch.sort(as_u32_i64(key), stable=True)
    gathered = [w[perm] for w in words]
    out = torch.stack(gathered) if gathered else key.new_empty((0, key.shape[0]))
    return as_i32(sorted_key), out


def sort_words(key: torch.Tensor, words: Sequence[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort [C] int32 bit patterns of uint32 keys ascending as unsigned
    values, with 0-4 int32 ``words`` ([>= C] each, indexed by slot) moved
    along.  Returns (sorted keys [C] int32, [len(words), C] int32: row w is
    ``words[w]`` in the keys' sorted order).  Stable: equal keys keep their
    slot order, so the result is torch.sort(as_u32_i64(key), stable=True)'s
    with its permutation gathered from each word.

    On the card three launches of csrc/sort.cu: the slot indices and a
    16-B record of each slot's words, cub's radix sort of (key, slot) at
    the key's 32 bits, a gather of the records by the sorted slots.  The
    scratch and the outputs are allocated here, with torch.empty, so a
    captured graph owns them; nothing is read back."""
    if len(words) > 4:
        raise ValueError(f"sort_words moves at most 4 words, got {len(words)}")
    if cb.dispatch_device(key) == "cpu":
        return _sort_words_torch(key, words)
    dev = key.device
    n = key.shape[0]
    cb.require(key, "key", torch.int32, dev, (n,))
    for i, w in enumerate(words):
        cb.require(w, f"words[{i}]", torch.int32, dev)
        if w.dim() != 1 or w.shape[0] < n:
            raise ValueError(f"words[{i}] has shape {tuple(w.shape)}, expected [>= {n}]")
    keys_out = torch.empty_like(key)
    out = torch.empty((len(words), n), dtype=torch.int32, device=dev)
    slots = torch.empty(n, dtype=torch.int32, device=dev)
    perm = torch.empty_like(slots)
    records = torch.empty((n if words else 0, 4), dtype=torch.int32, device=dev)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    temp = torch.empty(_temp_bytes(n, index), dtype=torch.uint8, device=dev)
    ptrs = [w.data_ptr() for w in words] + [0] * (4 - len(words))
    fn = cb.kernel("sort", "gsr_sort_words", [cb.P] * 5 + [cb.I32, cb.I64] + [cb.P] * 6
                   + [cb.I64, cb.P])
    code = fn(key.data_ptr(), *ptrs, len(words), n, keys_out.data_ptr(), out.data_ptr(),
              slots.data_ptr(), perm.data_ptr(), records.data_ptr(), temp.data_ptr(),
              temp.numel(), cb.stream_handle(key))
    cb.check("sort", code)
    sort_words.launches += 1
    return keys_out, out


sort_words.launches = 0


def sort_pairs(
    pairs: TilePairs, *, with_values: bool = False, stable: bool = False
) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor], Tuple[torch.Tensor, ...]]:
    """Sort the pair list by (tile asc, depth front-to-back).

    Returns (sorted key words, sorted values or None, sorted attr words).
    ``with_values`` also carries the splat indices and forces a stable
    sort; ``stable`` keeps emission order among equal keys.  The kernel
    path (``sort_path``) is stable whatever ``stable`` says, so there it
    returns exactly what the stable torch path returns.
    """
    if sort_path(pairs.keys[0].device.type, len(pairs.keys)) == "kernel":
        sources = (*pairs.attrs, pairs.values) if with_values else tuple(pairs.attrs)
        key, words = sort_words(pairs.keys[0], sources)
        n = len(pairs.attrs)
        return (key,), (words[n] if with_values else None), tuple(words[:n])
    return _sort_pairs_torch(pairs, with_values=with_values, stable=stable)


def _sort_pairs_torch(pairs: TilePairs, *, with_values: bool = False, stable: bool = False):
    """sort_pairs' torch path, on any device: one int64 key through
    torch.sort, then a gather of each word by the permutation."""
    if len(pairs.keys) == 1:
        key = as_u32_i64(pairs.keys[0])
    else:
        key = (as_u32_i64(pairs.keys[0]) << 32) | as_u32_i64(pairs.keys[1])
    sorted_key, perm = torch.sort(key, stable=stable or with_values)
    if len(pairs.keys) == 1:
        keys = (as_i32(sorted_key),)
    else:
        keys = (as_i32(sorted_key >> 32), as_i32(sorted_key & 0xFFFFFFFF))
    values = pairs.values[perm] if with_values else None
    attrs = tuple(a[perm] for a in pairs.attrs)
    return keys, values, attrs
