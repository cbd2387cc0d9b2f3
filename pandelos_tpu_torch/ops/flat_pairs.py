"""The flat pair list of an extraction: which (row gene, candidate) pair
each slot of ``flatten_join``'s list holds.

:func:`flat_pairs` takes an extraction's (grow, cand, counts), any
leading axes flattened row-major, and lays every row's first
``counts[r]`` candidates end to end (rows past the cap ``K`` emit none):
slot ``p`` below the total holds ``(grow[r], cand[r, p - base[r]])`` for
the row ``r`` whose slots span ``p``, and every later slot up to
``pair_cap`` holds ``(G, G)``.  CUDA tensors run ``csrc/flat_pairs.cu``
(a load-balanced fill over slots; or raise); CPU tensors take
:func:`flat_pairs_plain`, a sorted search of the rows' bounds.
``flat_pairs.launches`` counts the kernel's launches in the process; a
caller that counts its own passes a list (``launched``).
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Tuple

import torch

_lock = threading.Lock()  # shards fill their lists from worker threads


def _rows(grow, cand, counts):
    """(gf [R] int32, cf [R, K] int32, cs [R] int64): the row ids, the
    candidates and the inclusive prefix sum of the counts capped at
    ``K`` (0 past it)."""
    K = cand.shape[-1]
    gf = grow.reshape(-1).to(torch.int32).contiguous()
    cf = cand.reshape(-1, K).to(torch.int32).contiguous()
    nf = counts.reshape(-1)
    nf = torch.where(nf > K, torch.zeros_like(nf), nf)
    return gf, cf, torch.cumsum(nf, 0, dtype=torch.int64)


def flat_pairs_plain(gf, cf, cs, pair_cap: int,
                     G: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, its twin: each slot's row
    by a sorted search of the rows' bounds ``cs``, then two gathers."""
    dev = gf.device
    R, K = cf.shape
    pad = torch.full((pair_cap,), G, dtype=torch.int32, device=dev)
    if R == 0:
        return pad, pad.clone()
    p = torch.arange(pair_cap, dtype=torch.int64, device=dev)
    r = torch.clamp(torch.searchsorted(cs, p, right=True), max=R - 1)
    base = torch.where(r > 0, cs[torch.clamp(r - 1, min=0)],
                       torch.zeros_like(r))
    s = torch.clamp(p - base, 0, K - 1)
    ok = p < cs[-1]
    return (torch.where(ok, gf[r], pad), torch.where(ok, cf[r, s], pad))


@functools.lru_cache(maxsize=None)
def _entry(lib):
    """The kernel's entry point in ``lib``, its signature set once."""
    fn = lib.pt_flat_pairs
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    return fn


def _kernel(gf, cf, cs, pair_cap: int, G: int, launched):
    from pandelos_tpu_torch import kernels

    lib = kernels.load("flat_pairs")
    with _lock:  # shards' worker threads: one sets the signature
        fn = _entry(lib)
    dev = gf.device
    pi = torch.empty(pair_cap, dtype=torch.int32, device=dev)
    pj = torch.empty(pair_cap, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(gf.data_ptr(), cf.data_ptr(), cf.shape[1], cs.data_ptr(),
                cf.shape[0], pair_cap, G, pi.data_ptr(), pj.data_ptr(),
                stream)
    if rc != 0:
        raise RuntimeError(f"flat_pairs kernel launch failed: cudaError {rc}")
    with _lock:
        flat_pairs.launches += 1
    if launched is not None:
        launched.append(1)
    return pi, pj


def flat_pairs(grow, cand, counts, pair_cap: int, G: int,
               launched=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pi, pj), int32 [pair_cap], of the extraction (grow [..., R], cand
    [..., R, K], counts [..., R]) on one device: see the module's
    docstring.  Slots past ``pair_cap`` are dropped.  ``launched``, a
    list, gets a 1 for each launch of the kernel."""
    dev = cand.device
    if grow.device != dev or counts.device != dev:
        raise ValueError(f"grow on {grow.device}, counts on {counts.device}, "
                         f"cand on {dev}")
    if pair_cap < 0 or cand.shape[-1] == 0:
        raise ValueError(f"pair_cap {pair_cap}, K {cand.shape[-1]}")
    rows = _rows(grow, cand, counts)
    if dev.type == "cpu":
        return flat_pairs_plain(*rows, pair_cap, G)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _kernel(*rows, pair_cap, G, launched)


flat_pairs.launches = 0
