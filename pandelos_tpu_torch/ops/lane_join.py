"""Lane-bucketed exact profile joins (lane2 and lane): tables, depths,
and the hand-written CUDA kernels with their plain PyTorch versions.

For each candidate pair (gene A, gene B) a join computes the integer
counters of the reference's scoring kernel (``library.cpp:475-477``)::

    inter = sum over shared k-mers of min(cA, cB)
    perc  = sum over shared k-mers of cA
    tr    = sum over shared k-mers of cB

Profiles are re-laid so that k-mer id ``v`` always lives in lane
``v & 127``, at the depth of its rank among the gene's ids in that lane
(``[D, 128]`` per gene, ``D`` the largest depth over all genes).  Equal
ids are then lane-aligned and one compare per (depth_a, depth_b) slot row
replaces a merge.  Two table layouts:

- packed (lane2): one ``[G_pad, D*128]`` int32 table of ``id << 8 |
  count`` (count < 256, id < 2^23); an empty slot is ``-256``, which
  equals only another empty slot, whose count is 0;
- unpacked (lane): ``[G_pad, 2*D*128]``, ids then counts; an empty slot
  has id -1 and count 0.  Any count and id fit: it is lane2's exact
  fallback for inputs that cannot pack.

``lane2_join`` and ``lane_join`` run the CUDA kernels
``csrc/lane2_join.cu`` and ``csrc/lane_join.cu`` on CUDA tensors and the
plain versions :func:`lane2_join_plain` and :func:`lane_join_plain` on
CPU tensors; their ``launches`` attributes count kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from pandelos_tpu_torch import tracing

_LANE = 128
_EMPTY = -256
# packed entries: id << 8 | count needs count < 256 and id < 2^23
_PACK_COUNT_LIMIT = 1 << 8
_PACK_ID_LIMIT = 1 << 23
# the lane table builder's row chunk: its int32 [rows, W, 128] running
# count stays under this
_BUILD_CHUNK_BYTES = 1 << 28


def lane_depths(index) -> np.ndarray:
    """Per-gene max lane depth [G] int32 (0 for empty profiles) — the
    per-pair loop bounds of the lane2 join."""
    cache = getattr(index, "_pad_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(index, "_pad_cache", cache)
    if "laneDg" in cache:
        return cache["laneDg"]
    G = index.n_sequences
    ids = np.asarray(index.profile_ids)
    if ids.size == 0:
        dg = np.zeros(G, np.int32)
    else:
        widths = np.diff(index.profile_ptr)
        g_of = np.repeat(np.arange(G, dtype=np.int64), widths)
        keys = g_of * _LANE + (ids.astype(np.int64) & (_LANE - 1))
        per_lane = np.bincount(keys, minlength=G * _LANE)
        dg = per_lane.reshape(G, _LANE).max(axis=1).astype(np.int32)
    cache["laneDg"] = dg
    return dg


def lane_depth(index) -> int:
    """The table depth ``D``: the max (gene, lane) multiplicity, >= 1."""
    dg = lane_depths(index)
    return max(1, int(dg.max(initial=0)))


def pack_lane_device_core(
    ids: torch.Tensor, counts: torch.Tensor, D: int, packed: bool = True,
    chunk_bytes: int = _BUILD_CHUNK_BYTES,
) -> torch.Tensor:
    """[G_pad, W] padded profiles (``pad_profiles`` layout: id-sorted,
    left-packed, count 0 marks padding) -> a lane table: with ``packed``
    the lane2 table [G_pad, D*128] int32 of ``id << 8 | count`` entries,
    empty slots ``-256`` (raises ValueError when a count or id does not
    fit); otherwise the lane table [G_pad, 2*D*128] int32, ids then
    counts, empty slots id -1 and count 0.

    Per row chunk: lane = id & 127; depth = rank of the slot within its
    (row, lane) group, by a cumsum over the 128-wide lane one-hot (ids
    ascend along the row, so depth ascends with id); each valid slot
    scatters to ``depth*128 + lane``, padding slots to a per-slot dump
    column past the table.  The row chunk keeps the one-hot temporary
    under ``chunk_bytes``."""
    G_pad, W = ids.shape
    WL = D * _LANE
    dev = ids.device
    if packed and ids.numel():
        with tracing.blocked():
            lims = torch.stack([counts.max(), ids.max()]).tolist()
        if lims[0] >= _PACK_COUNT_LIMIT or lims[1] >= _PACK_ID_LIMIT:
            raise ValueError(
                f"the packed lane table needs counts < {_PACK_COUNT_LIMIT} "
                f"and ids < {_PACK_ID_LIMIT}; got max count {lims[0]}, max "
                f"id {lims[1]} (build the unpacked table, packed=False)"
            )
    out = torch.full(
        (G_pad, WL if packed else 2 * WL), _EMPTY if packed else -1,
        dtype=torch.int32, device=dev,
    )
    if not packed:
        out[:, WL:] = 0
    rc = max(1, min(G_pad, chunk_bytes // max(1, W * _LANE * 4)))
    lanes = torch.arange(_LANE, dtype=torch.int32, device=dev)
    dump = WL + torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    for r0 in range(0, G_pad, rc):
        idc = ids[r0:r0 + rc]
        cnc = counts[r0:r0 + rc]
        C = idc.shape[0]
        valid = cnc > 0
        lane = idc & (_LANE - 1)
        onehot = (lane[:, :, None] == lanes) & valid[:, :, None]
        cum = onehot.cumsum(1, dtype=torch.int32)
        depth = cum.gather(2, lane[..., None].long())[..., 0] - 1
        pos = torch.where(valid, (depth * _LANE + lane).long(), dump)
        if packed:
            parts = [(torch.where(valid, (idc << 8) | cnc,
                                  torch.full_like(idc, _EMPTY)), _EMPTY)]
        else:
            parts = [(torch.where(valid, idc, torch.full_like(idc, -1)), -1),
                     (torch.where(valid, cnc, torch.zeros_like(cnc)), 0)]
        for h, (vals, fill) in enumerate(parts):
            blk = torch.full((C, WL + W), fill, dtype=torch.int32, device=dev)
            blk.scatter_(1, pos, vals)
            out[r0:r0 + C, h * WL:(h + 1) * WL] = blk[:, :WL]
    return out


def build_temp_bytes(G_pad: int, W: int,
                     chunk_bytes: int = _BUILD_CHUNK_BYTES) -> int:
    """Device bytes that :func:`pack_lane_device_core` holds besides
    its table, at most: a row chunk's [rows, W, 128] one-hot (bool), its
    int32 cast and int32 running count (9 bytes an element), and one
    byte an element more for the chunk's [rows, W] temporaries and its
    scatter block."""
    rc = max(1, min(G_pad, chunk_bytes // max(1, W * _LANE * 4)))
    return 10 * rc * W * _LANE


def _lane_plain(slot, dg, a_idx, b_idx, pair_chunk):
    """The plain join over slot rows: ``slot(genes, i)`` gives the keys
    and counts [C, 128] of depth row ``i`` of each gene; equal keys in a
    lane are a shared k-mer (empty slots carry count 0).  The same
    per-pair depth bounds as the kernels, int32 counters, f32 outputs;
    tensor ops over (pairs x 128 lanes), pairs in chunks."""
    P = a_idx.shape[0]
    dev = dg.device
    outs = [torch.zeros(P, dtype=torch.float32, device=dev) for _ in range(3)]
    for c0 in range(0, P, pair_chunk):
        a = a_idx[c0:c0 + pair_chunk].long()
        b = b_idx[c0:c0 + pair_chunk].long()
        da = dg[a]
        db = dg[b]
        n_a = int(da.max()) if a.numel() else 0
        n_b = int(db.max()) if b.numel() else 0
        acc = [torch.zeros(a.shape[0], dtype=torch.int32, device=dev)
               for _ in range(3)]
        for i in range(n_a):
            kx, cx = slot(a, i)  # [C, 128]
            a_on = (i < da)[:, None]
            zero = torch.zeros_like(cx)
            for j in range(n_b):
                ky, cy = slot(b, j)
                eq = (kx == ky) & a_on & (j < db)[:, None]
                acc[0] += torch.where(eq, torch.minimum(cx, cy), zero).sum(
                    1, dtype=torch.int32)
                acc[1] += torch.where(eq, cx, zero).sum(1, dtype=torch.int32)
                acc[2] += torch.where(eq, cy, zero).sum(1, dtype=torch.int32)
        for o, v in zip(outs, acc):
            o[c0:c0 + pair_chunk] = v.to(torch.float32)
    return tuple(outs)


def lane2_join_plain(table, dg, a_idx, b_idx, pair_chunk: int = 1 << 15):
    """Plain PyTorch lane2 join, the kernel's twin, over the packed table
    (``((x ^ y) >> 8) == 0`` is ``x >> 8 == y >> 8``; an empty slot's
    key is -1)."""
    G_pad, WL = table.shape
    t3 = table.view(G_pad, WL // _LANE, _LANE)

    def slot(g, i):
        x = t3[g, i]
        return x >> 8, x & 255

    return _lane_plain(slot, dg, a_idx, b_idx, pair_chunk)


def lane_join_plain(table, dg, a_idx, b_idx, pair_chunk: int = 1 << 15):
    """Plain PyTorch lane join, the kernel's twin, over the unpacked
    table (ids then counts; an empty slot's id is -1)."""
    G_pad, W2 = table.shape
    D = W2 // (2 * _LANE)
    t4 = table.view(G_pad, 2, D, _LANE)

    def slot(g, i):
        return t4[g, 0, i], t4[g, 1, i]

    return _lane_plain(slot, dg, a_idx, b_idx, pair_chunk)


def _check_args(table, dg, a_idx, b_idx, row_unit):
    ts = {"table": table, "dg": dg, "a_idx": a_idx, "b_idx": b_idx}
    for name, t in ts.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != table.device:
            raise ValueError(
                f"{name} is on {t.device}, table on {table.device}"
            )
    if table.dim() != 2 or table.shape[1] == 0 or table.shape[1] % row_unit:
        raise ValueError(
            f"table must be [G_pad, D*{row_unit}], got {tuple(table.shape)}"
        )
    if dg.dim() != 1 or dg.shape[0] != table.shape[0]:
        raise ValueError(
            f"dg must be [G_pad={table.shape[0]}], got {tuple(dg.shape)}"
        )
    if a_idx.dim() != 1 or a_idx.shape != b_idx.shape:
        raise ValueError(
            f"a_idx/b_idx must be equal 1-D shapes, got "
            f"{tuple(a_idx.shape)} / {tuple(b_idx.shape)}"
        )


def check_pair_indices(a_idx, b_idx, G_pad: int, dg=None, D: int = 0):
    """Raise unless every pair index lies in [0, G_pad) and, with ``dg``,
    every depth in [0, D]: a kernel reads rows by index and depth (one
    device-to-host sync for all of it)."""
    lims = [*torch.aminmax(a_idx), *torch.aminmax(b_idx)]
    if dg is not None:
        lims += torch.aminmax(dg)
    with tracing.blocked():
        lims = torch.stack(lims).tolist()
    lo, hi = min(lims[0], lims[2]), max(lims[1], lims[3])
    if lo < 0 or hi >= G_pad:
        raise ValueError(
            f"pair indices span [{lo}, {hi}], outside [0, {G_pad})"
        )
    if dg is not None and (lims[4] < 0 or lims[5] > D):
        raise ValueError(
            f"depths span [{lims[4]}, {lims[5]}], outside [0, {D}]"
        )


_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
]


def _lane_join(wrapper, plain, row_unit, table, dg, a_idx, b_idx):
    """Shared body of the lane join wrappers: argument checks, the plain
    version for CPU tensors, the kernel ``csrc/<wrapper name>.cu`` for
    CUDA tensors (or a raise); counts the launch on ``wrapper``."""
    name = wrapper.__name__
    _check_args(table, dg, a_idx, b_idx, row_unit)
    if table.device.type == "cpu":
        return plain(table, dg, a_idx, b_idx)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    G_pad, WT = table.shape
    D = WT // row_unit
    P = a_idx.shape[0]
    outs = tuple(
        torch.empty(P, dtype=torch.float32, device=table.device)
        for _ in range(3)
    )
    if P == 0:
        return outs
    check_pair_indices(a_idx, b_idx, G_pad, dg, D)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned: the kernel reads "
                         "its rows with 16-byte loads")
    from pandelos_tpu_torch import kernels

    fn = getattr(kernels.load(name), "pt_" + name)
    fn.restype = ctypes.c_int
    fn.argtypes = _ARGTYPES
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = fn(
            table.data_ptr(), WT, dg.data_ptr(), a_idx.data_ptr(),
            b_idx.data_ptr(), P, outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    wrapper.launches += 1
    return outs


def lane2_join(table, dg, a_idx, b_idx):
    """Exact counters (inter, perc, tr), f32 [P], for pairs
    ``(a_idx[p], b_idx[p])`` over the packed lane2 ``table`` [G_pad,
    D*128] with per-gene depths ``dg``.  CUDA tensors launch the kernel
    (or raise); CPU tensors take :func:`lane2_join_plain`.  Indices must
    lie in ``[0, G_pad)`` and depths in ``[0, D]``: the kernel reads rows
    by index, so both are checked before the launch."""
    return _lane_join(lane2_join, lane2_join_plain, _LANE,
                      table, dg, a_idx, b_idx)


def lane_join(table, dg, a_idx, b_idx):
    """:func:`lane2_join` over the unpacked lane ``table`` [G_pad,
    2*D*128] (ids then counts): any count and id, the fallback for
    inputs lane2 cannot pack.  CUDA tensors launch ``csrc/lane_join.cu``
    (or raise); CPU tensors take :func:`lane_join_plain`.  The kernel
    relies on the table's lane rule (a valid id ``v`` sits in lane
    ``v & 127``, as :func:`pack_lane_device_core` lays it)."""
    return _lane_join(lane_join, lane_join_plain, 2 * _LANE,
                      table, dg, a_idx, b_idx)


lane2_join.launches = 0
lane_join.launches = 0
