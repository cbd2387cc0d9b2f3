"""The k-mer multiset index of ``build_index`` on a torch device:
``csrc/kmer_index.cu`` on a card, its plain PyTorch twin elsewhere, and
the copies around them.

:func:`kmer_index` takes the concatenated residues (uint8) and the
per-gene offsets (int64) of a dataset, both on one device, and ``k``, and
returns the CSR by gene over the shared vocabulary (pointer, ids
ascending within a gene, counts), the per-gene computation costs,
``vocab_size`` and ``total_vocab``, as host NumPy arrays and ints: bit
for bit what ``index.py``'s NumPy build and the JAX package's index
give.  CUDA tensors run the kernels (or raise); CPU tensors take
:func:`kmer_index_plain`, which may use ``torch.sort`` and
``torch.unique``.  ``kmer_index.launches`` counts the kernels launched.

Both replace the reference's preprocessing core
(``ig/native/library.cpp:189-371``); the JAX package has no kernel for
it (it builds on the host).  The card path is bound by bytes: passes
over the windows, the entries and the groups (the source's header says
how).  The host waits on the card three times: for the alphabet and the
window count (1 KB), for the CSR pointer, costs and counts, and for the
ids and counts, which come back once into pinned memory from PyTorch's
caching host allocator; the arrays handed out are views of it.

Both versions take a window's key as its k dense ranks (the alphabet in
ascending byte order) packed as ``(key << gene_bits) | gene``, and raise
where that does not fit in 63 bits or the windows pass 2^31.
:func:`fits_packed_key` makes that test on the host arrays before
anything goes up, so ``build_index`` gives such a dataset to its NumPy
build without touching the device.
"""

from __future__ import annotations

import ctypes
import warnings
from typing import NoReturn, Optional, Tuple

import numpy as np
import torch

from pandelos_tpu_torch import tracing

# (profile_ptr, profile_ids, profile_counts, computation_costs,
#  vocab_size, total_vocab): KmerIndex's fields of those names
IndexArrays = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int, int]

# the composite key (key << gene_bits) | gene stays a non-negative int64
_KEY_BITS_MAX = 63
# window positions are int32 on the card
_WINDOWS_MAX = 1 << 31
_HEAD_PRESENT_BYTES = 1024  # 256 int32: the bytes present


def key_layout(n_present: int, k: int,
               n_genes: int) -> Optional[Tuple[int, int, int]]:
    """(base, key bits, gene bits) of the packed key of a dataset with
    ``n_present`` distinct bytes and ``n_genes`` genes, or None where
    ``(key << gene_bits) | gene`` would not fit in 63 bits."""
    base = max(1, n_present)
    key_bits = (base ** k - 1).bit_length()
    gene_bits = max(0, n_genes - 1).bit_length()
    if key_bits + gene_bits > _KEY_BITS_MAX:
        return None
    return base, key_bits, gene_bits


def _host_tensor(a: np.ndarray, dtype) -> torch.Tensor:
    """``a`` as a CPU tensor sharing its memory where it can."""
    with warnings.catch_warnings():
        # the encoded residues are a read-only view of their bytes; they
        # are only read
        warnings.filterwarnings("ignore", "The given NumPy array is not "
                                "writable", UserWarning)
        return torch.from_numpy(np.ascontiguousarray(a, dtype))


def fits_packed_key(concat: np.ndarray, offsets: np.ndarray,
                    k: int) -> bool:
    """Whether :func:`kmer_index` takes the host arrays ``concat`` and
    ``offsets`` at ``k``: there is a gene, the packed key fits in 63 bits
    and the windows stay under 2^31, by a census of the residues on the
    host."""
    G = offsets.shape[0] - 1
    if G < 1:
        return False
    n = int(np.maximum(np.diff(offsets) - k + 1, 0).sum())
    n_present = int(torch.count_nonzero(torch.bincount(
        _host_tensor(concat, np.uint8), minlength=256))) if concat.size else 0
    return key_layout(n_present, k, G) is not None and n < _WINDOWS_MAX


def _refuse(k: int, n_present: int, n_genes: int, n: int) -> NoReturn:
    raise ValueError(
        f"the device build cannot take {n} windows of k {k} over "
        f"{n_present} residues and {n_genes} genes: the packed key passes "
        f"63 bits or the windows 2^31 (fits_packed_key)")


def _empty(n_genes: int) -> IndexArrays:
    return (np.zeros(n_genes + 1, np.int64), np.zeros(0, np.int32),
            np.zeros(0, np.int32), np.zeros(n_genes, np.int64), 0, 0)


def kmer_index_plain(concat: torch.Tensor, offsets: torch.Tensor,
                     k: int) -> IndexArrays:
    """The plain PyTorch version of the card build, the kernels' twin:
    the same census, packed keys and refusal, then a sort and run-length
    groupings in place of the kernels' radix sort and compactions.  It
    runs on the tensors' device (:func:`kmer_index` hands it CPU tensors
    only; ``chip_smoke.py`` times it on the card)."""
    G = offsets.shape[0] - 1
    dev = concat.device
    present = (torch.bincount(concat.long(), minlength=256) > 0
               if concat.numel() else
               torch.zeros(256, dtype=torch.bool, device=dev))
    lens = offsets[1:] - offsets[:-1]
    nwin = (lens - k + 1).clamp(min=0)
    win_off = torch.zeros(G + 1, dtype=torch.int64, device=dev)
    torch.cumsum(nwin, 0, out=win_off[1:])
    n = int(win_off[-1])
    layout = key_layout(int(present.sum()), k, G)
    if layout is None or n >= _WINDOWS_MAX:
        _refuse(k, int(present.sum()), G, n)
    base, _, gene_bits = layout
    if n == 0:
        return _empty(G)
    rank = torch.cumsum(present.long(), 0) - present.long()
    w = torch.arange(n, dtype=torch.int64, device=dev)
    gene = torch.searchsorted(win_off, w, right=True) - 1
    pos = offsets[gene] + (w - win_off[gene])
    key = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(k):
        key = key * base + rank[concat[pos + j].long()]
    comp = (key << gene_bits) | gene
    entries, counts = torch.unique(comp, sorted=True, return_counts=True)
    e_key = entries >> gene_bits
    e_gene = entries & ((1 << gene_bits) - 1)
    _, e_grp, g_size = torch.unique_consecutive(
        e_key, return_inverse=True, return_counts=True)
    shared = g_size >= 2
    sid = torch.cumsum(shared.long(), 0) - 1
    keep = shared[e_grp]
    kept_gene = e_gene[keep]
    kept_sid = sid[e_grp[keep]]
    kept_cnt = counts[keep]
    costs = torch.zeros(G, dtype=torch.int64, device=dev).index_add_(
        0, kept_gene, g_size[e_grp[keep]])
    order = torch.sort(kept_gene, stable=True).indices
    ptr = torch.zeros(G + 1, dtype=torch.int64, device=dev)
    torch.cumsum(torch.bincount(kept_gene, minlength=G), 0, out=ptr[1:])
    return (ptr.cpu().numpy(), kept_sid[order].to(torch.int32).cpu().numpy(),
            kept_cnt[order].to(torch.int32).cpu().numpy(),
            costs.cpu().numpy(), int(shared.sum()), int(g_size.shape[0]))


def _check_args(concat, offsets, k):
    for name, t, dtype in (("concat", concat, torch.uint8),
                           ("offsets", offsets, torch.int64)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if offsets.device != concat.device:
        raise ValueError(
            f"offsets is on {offsets.device}, concat on {concat.device}")
    if offsets.shape[0] < 2:
        raise ValueError("offsets must hold at least one gene")
    if k <= 0:
        raise ValueError("K value must be greater than 0")


def _fn(lib, name, *argtypes):
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)


def _pinned_copy(src: torch.Tensor) -> torch.Tensor:
    """An asynchronous copy of ``src`` into pinned host memory."""
    out = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    out.copy_(src, non_blocking=True)
    return out


def _kernels(concat, offsets, k) -> IndexArrays:
    from pandelos_tpu_torch import kernels

    lib = kernels.load("kmer_index")
    prepare = _fn(lib, "pt_kmer_prepare", _P, _LL, _P, _LL, _I, _P, _P, _IP)
    entries = _fn(lib, "pt_kmer_entries", _P, _P, _P, _LL, _LL, _I,
                  ctypes.c_uint, _I, _I, _P, _P, _P, _IP)
    csr = _fn(lib, "pt_kmer_csr", _P, _LL, _LL, _I, _I, _LL, _P, _P, _IP)
    workspace = lib.pt_kmer_workspace_bytes
    workspace.restype = _LL
    workspace.argtypes = [_LL, _LL]

    dev = concat.device
    G = offsets.shape[0] - 1
    launched = ctypes.c_int(0)

    def check(rc, what):
        kmer_index.launches += launched.value
        launched.value = 0
        if rc != 0:
            raise RuntimeError(f"{what} launch failed: cudaError {rc}")

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        st = stream.cuda_stream
        head = torch.empty(_HEAD_PRESENT_BYTES + 8 * (2 * G + 1),
                           dtype=torch.uint8, device=dev)
        check(prepare(concat.data_ptr(), concat.shape[0], offsets.data_ptr(),
                      G, k, head.data_ptr(), st, ctypes.byref(launched)),
              "pt_kmer_prepare")
        present = _pinned_copy(head[:_HEAD_PRESENT_BYTES].view(torch.int32))
        tail = _HEAD_PRESENT_BYTES + 8 * (2 * G)
        n_h = _pinned_copy(head[tail:].view(torch.int64))
        with tracing.blocked():
            stream.synchronize()
        kmer_index.bytes_to_host += present.nbytes + n_h.nbytes
        n = int(n_h[0])
        n_present = int(np.count_nonzero(present.numpy()))
        layout = key_layout(n_present, k, G)
        if layout is None or n >= _WINDOWS_MAX:
            _refuse(k, n_present, G, n)
        if n == 0:
            return _empty(G)
        base, key_bits, gene_bits = layout
        work = torch.empty(workspace(n, G), dtype=torch.uint8, device=dev)
        small = torch.empty(2 * G + 5, dtype=torch.int64, device=dev)
        check(entries(concat.data_ptr(), offsets.data_ptr(), head.data_ptr(),
                      G, n, k, base, key_bits, gene_bits, work.data_ptr(),
                      small.data_ptr(), st, ctypes.byref(launched)),
              "pt_kmer_entries")
        small_h = _pinned_copy(small)
        with tracing.blocked():
            stream.synchronize()
        kmer_index.bytes_to_host += small_h.nbytes
        total_vocab, vocab_size, nnz = small_h[-3:].tolist()
        ids, counts = np.zeros(0, np.int32), np.zeros(0, np.int32)
        if nnz:
            big = torch.empty(2 * nnz, dtype=torch.int32, device=dev)
            check(csr(work.data_ptr(), n, G, key_bits, gene_bits, nnz,
                      big.data_ptr(), st, ctypes.byref(launched)),
                  "pt_kmer_csr")
            big_h = _pinned_copy(big)
            with tracing.blocked():
                stream.synchronize()
            kmer_index.bytes_to_host += big_h.nbytes
            ids, counts = big_h[:nnz].numpy(), big_h[nnz:].numpy()
    return (small_h[:G + 1].numpy(), ids, counts,
            small_h[G + 1:2 * G + 1].numpy(), vocab_size, total_vocab)


def kmer_index(concat: torch.Tensor, offsets: torch.Tensor,
               k: int) -> IndexArrays:
    """The index of the genes ``concat[offsets[g]:offsets[g+1]]`` (uint8
    residues, int64 offsets, one device) at ``k``: (profile_ptr,
    profile_ids, profile_counts, computation_costs, vocab_size,
    total_vocab).  CUDA tensors run ``csrc/kmer_index.cu``; CPU tensors
    take :func:`kmer_index_plain`.  Both raise ValueError where the
    packed key does not fit (see :func:`fits_packed_key`)."""
    _check_args(concat, offsets, k)
    if concat.device.type == "cpu":
        return kmer_index_plain(concat, offsets, k)
    if concat.device.type != "cuda":
        raise ValueError(f"unsupported device {concat.device}")
    return _kernels(concat, offsets, k)


kmer_index.launches = 0
kmer_index.bytes_to_host = 0


def index_on_device(concat: np.ndarray, offsets: np.ndarray, k: int,
                    device) -> IndexArrays:
    """:func:`kmer_index` of host arrays, which :func:`fits_packed_key`
    passed, on ``device``: on a card the inputs go up once.  The span
    ``index.device`` records the windows, nnz, ``total_vocab``,
    ``vocab_size``, the kernels launched, the bytes each way and (through
    :func:`tracing.blocked`) the host's waits."""
    with tracing.span("index.device") as sp:
        launches = kmer_index.launches
        to_host = kmer_index.bytes_to_host
        c = _host_tensor(concat, np.uint8).to(device)
        o = _host_tensor(offsets, np.int64).to(device)
        if c.device.type != "cpu":
            sp.set("bytes_to_card", c.numel() + 8 * o.numel())
        out = kmer_index(c, o, k)
        sp.set("launches", kmer_index.launches - launches)
        sp.set("bytes_to_host", kmer_index.bytes_to_host - to_host)
        sp.set("windows", int(np.maximum(np.diff(offsets) - k + 1, 0).sum()))
        sp.set("nnz", int(out[1].shape[0]))
        sp.set("total_vocab", out[5])
        sp.set("vocab_size", out[4])
    return out
