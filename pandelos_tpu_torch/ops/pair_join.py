"""Exact per-pair profile join over the padded profiles (join kernel
"roll"): the pair table, the hand-written CUDA kernel with its plain
PyTorch version, and the host API with dedup and mirror.

For each candidate pair (gene A, gene B) the join computes the integer
counters of the reference's scoring kernel (``library.cpp:475-477``)::

    inter = sum over shared k-mers of min(cA, cB)
    perc  = sum over shared k-mers of cA
    tr    = sum over shared k-mers of cB

The table is ``[G_pad, 2W]`` int32, one row per gene: the ``pad_profiles``
ids (id-sorted, left-packed, distinct) then their counts; padding slots
have count 0 (and id ``vocab_size``, which no real id equals).  Both rows
of a pair are sorted, so the join is a sorted search: every entry of
row A is looked up in row B.  The JAX package's TPU kernel rotates the B
tile through all 128 lane alignments instead; it gives the same counters.

``join_pairs_core`` runs the CUDA kernel ``csrc/pair_join.cu`` on CUDA
tensors and :func:`join_pairs_plain` on CPU tensors;
``join_pairs_core.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pandelos_tpu_torch.ops.lane_join import check_pair_indices

_INT32_MAX = 2**31 - 1


def pack_profiles(ids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """[G_pad, W] ids + counts -> the [G_pad, 2W] int32 pair table
    (ids || counts), on the device of ``ids``."""
    return torch.cat([ids, counts], dim=1).to(torch.int32).contiguous()


def join_pairs_plain(all_pair, a_idx, b_idx, pair_chunk: int = 1 << 14):
    """Plain PyTorch join, the kernel's twin: per pair, each valid entry
    of row A is searched in row B (``torch.searchsorted`` over B's ids,
    its padding keyed past every id); int32 counters, f32 outputs."""
    G_pad, W2 = all_pair.shape
    W = W2 // 2
    P = a_idx.shape[0]
    dev = all_pair.device
    outs = [torch.zeros(P, dtype=torch.float32, device=dev) for _ in range(3)]
    for c0 in range(0, P, pair_chunk):
        A = all_pair[a_idx[c0:c0 + pair_chunk].long()]
        B = all_pair[b_idx[c0:c0 + pair_chunk].long()]
        ai, ac = A[:, :W], A[:, W:]
        bi, bc = B[:, :W], B[:, W:]
        bkey = torch.where(bc > 0, bi, torch.full_like(bi, _INT32_MAX))
        pos = torch.clamp(torch.searchsorted(bkey, ai.contiguous()), max=W - 1)
        cb = bc.gather(1, pos)
        hit = (bkey.gather(1, pos) == ai) & (ac > 0) & (cb > 0)
        zero = torch.zeros_like(ac)
        acc = (
            torch.where(hit, torch.minimum(ac, cb), zero),
            torch.where(hit, ac, zero),
            torch.where(hit, cb, zero),
        )
        for o, v in zip(outs, acc):
            o[c0:c0 + pair_chunk] = v.sum(1, dtype=torch.int32).to(
                torch.float32)
    return tuple(outs)


def _check_args(all_pair, a_idx, b_idx):
    ts = {"all_pair": all_pair, "a_idx": a_idx, "b_idx": b_idx}
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != all_pair.device:
            raise ValueError(
                f"{name} is on {t.device}, all_pair on {all_pair.device}"
            )
    if all_pair.dim() != 2 or all_pair.shape[1] == 0 or all_pair.shape[1] % 2:
        raise ValueError(
            f"all_pair must be [G_pad, 2W], got {tuple(all_pair.shape)}"
        )
    if a_idx.dim() != 1 or a_idx.shape != b_idx.shape:
        raise ValueError(
            f"a_idx/b_idx must be equal 1-D shapes, got "
            f"{tuple(a_idx.shape)} / {tuple(b_idx.shape)}"
        )


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p,
]


def join_pairs_core(all_pair, a_idx, b_idx):
    """Exact counters (inter, perc, tr), f32 [P], perc relative to the
    a-side, for pairs ``(a_idx[p], b_idx[p])`` over the pair table.  CUDA
    tensors launch the kernel (or raise); CPU tensors take
    :func:`join_pairs_plain`.  Indices must lie in ``[0, G_pad)``: the
    kernel reads rows by index, so they are checked before the launch."""
    _check_args(all_pair, a_idx, b_idx)
    if all_pair.device.type == "cpu":
        return join_pairs_plain(all_pair, a_idx, b_idx)
    if all_pair.device.type != "cuda":
        raise ValueError(f"unsupported device {all_pair.device}")
    P = a_idx.shape[0]
    outs = tuple(
        torch.empty(P, dtype=torch.float32, device=all_pair.device)
        for _ in range(3)
    )
    if P == 0:
        return outs
    check_pair_indices(a_idx, b_idx, all_pair.shape[0])
    from pandelos_tpu_torch import kernels

    fn = kernels.load("pair_join").pt_pair_join
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES
    with torch.cuda.device(all_pair.device):
        stream = torch.cuda.current_stream(all_pair.device).cuda_stream
        rc = fn(
            all_pair.data_ptr(), all_pair.shape[1] // 2, a_idx.data_ptr(),
            b_idx.data_ptr(), P, outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"pair_join kernel launch failed: cudaError {rc}")
    join_pairs_core.launches += 1
    return outs


join_pairs_core.launches = 0


def join_pairs(all_pair, i, j, assume_unique: bool = False):
    """Exact counters (inter, perc, tr) f32 numpy [P_in], perc with
    respect to ``i``, for the gene pairs ``(i[p], j[p])`` (numpy ints)
    over the pair table ``all_pair`` on its device.

    Each unordered pair is joined once, in canonical ``lo < hi``
    orientation (``np.unique`` keeps the list lo-major, so runs of pairs
    share their A row), and the counters are mirrored to every duplicate
    and reversed occurrence (``perc(i, j) == tr(j, i)``).  With
    ``assume_unique`` (every pair occurs once, already oriented as the
    caller wants it) the pairs are joined as given."""
    P_in = len(i)
    if P_in == 0:
        z = np.zeros(0, np.float32)
        return z, z, z
    i = np.asarray(i, dtype=np.int64)
    j = np.asarray(j, dtype=np.int64)
    if assume_unique:
        rep_lo, rep_hi = i, j
    else:
        lo = np.minimum(i, j)
        hi = np.maximum(i, j)
        g1 = np.int64(all_pair.shape[0] + 1)
        uniq, inv = np.unique(lo * g1 + hi, return_inverse=True)
        rep_lo, rep_hi = uniq // g1, uniq % g1

    def put(x):
        return torch.from_numpy(x.astype(np.int32)).to(all_pair.device)

    u = [o.cpu().numpy() for o in join_pairs_core(all_pair, put(rep_lo),
                                                  put(rep_hi))]
    if assume_unique:
        return tuple(u)
    swap = i > j  # the pair was joined as (j, i): perc and tr exchange
    inter = u[0][inv]
    perc = np.where(swap, u[2][inv], u[1][inv])
    tr = np.where(swap, u[1][inv], u[2][inv])
    return inter, perc, tr
