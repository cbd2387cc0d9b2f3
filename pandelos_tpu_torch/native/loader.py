"""Build + load the port's native host core via ctypes: the clustering's
Girvan-Newman split and the ``.net`` writer's formatting.

The shared library is compiled on first use with g++ into ``build/`` next
to this file (plain C ABI + ctypes).  A failed build raises with the
compiler's output: neither the Girvan-Newman split nor the ``.net``
writer drops to its Python twin quietly.  Set ``PANDELOS_NATIVE=0`` to
ask for the twins explicitly.  ``CALLS`` counts the native calls made,
so a run can show that it went through the native core.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "host_index.cpp")
_SO = os.path.join(_HERE, "build", "libpandelos_host.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_disabled = False
# native calls made by this process, by entry point
CALLS = {"gn_split": 0, "gn_families": 0, "format_net": 0}


def _build_so() -> None:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-std=c++17",
        "-shared",
        "-fPIC",
        "-pthread",
        _SRC,
        "-o",
        _SO,
    ]
    tmp = _SO + f".{os.getpid()}.tmp"
    res = subprocess.run(cmd[:-1] + [tmp], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"g++ failed to build the native host core ({' '.join(cmd)}):\n"
            f"{res.stdout}{res.stderr}"
        )
    os.replace(tmp, _SO)  # atomic: a concurrent loader sees all or nothing


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _disabled
    if _lib is not None or _disabled:
        return _lib
    with _lock:
        if _lib is not None or _disabled:
            return _lib
        if os.environ.get("PANDELOS_NATIVE", "1") == "0":
            _disabled = True
            return None
        if (not os.path.exists(_SO)) or os.path.getmtime(
            _SO
        ) < os.path.getmtime(_SRC):
            _build_so()
        lib = ctypes.CDLL(_SO)
        lib.pt_free.restype = None
        lib.pt_free.argtypes = [ctypes.c_void_p]
        lib.pt_gn_split.restype = ctypes.c_int
        lib.pt_gn_split.argtypes = [
            ctypes.c_int32,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.pt_pyset_order.restype = ctypes.c_int64
        lib.pt_pyset_order.argtypes = [i64p, ctypes.c_int64, i64p]
        lib.pt_gn_families.restype = ctypes.c_int
        lib.pt_gn_families.argtypes = (
            [ctypes.c_int64] * 3 + [i64p] * 7 + [ctypes.c_int32] + [i64p] * 4
            + [ctypes.POINTER(ctypes.c_double), ctypes.POINTER(i64p), i64p])
        lib.pt_format_net.restype = ctypes.c_int
        lib.pt_format_net.argtypes = [
            i64p, i64p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.POINTER(ctypes.c_void_p), i64p,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _i64(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def native_write_net(
    path: str, a: np.ndarray, b: np.ndarray, w32: np.ndarray,
    n_threads: int = 0,
) -> Optional[Tuple[int, int]]:
    """Write the ``.net`` lines of the edges ``(a[i], b[i], w32[i])``, in
    the order given, to ``path``: ``pt_format_net`` formats them on
    ``n_threads`` native threads (0: the host's cores), the GIL released,
    into one buffer that one ``write`` puts in the file.  Returns (bytes
    written, threads used), or None when the native library is
    unavailable."""
    lib = _load()
    if lib is None:
        return None
    a = np.ascontiguousarray(a, dtype=np.int64)
    b = np.ascontiguousarray(b, dtype=np.int64)
    w32 = np.ascontiguousarray(w32, dtype=np.float32)
    if not (len(a) == len(b) == len(w32)):
        raise ValueError("native_write_net: a, b and w32 differ in length")
    buf = ctypes.c_void_p()
    n_bytes = ctypes.c_int64()
    used = ctypes.c_int32()
    CALLS["format_net"] += 1
    rc = lib.pt_format_net(
        _i64(a), _i64(b), w32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(a)), ctypes.c_int32(n_threads),
        ctypes.byref(buf), ctypes.byref(n_bytes), ctypes.byref(used))
    if rc != 0:
        raise RuntimeError(f"pt_format_net failed ({rc})")
    try:
        with open(path, "wb") as fh:
            if n_bytes.value:
                fh.write((ctypes.c_char * n_bytes.value).from_address(
                    buf.value))
    finally:
        lib.pt_free(buf)
    return n_bytes.value, used.value


def native_gn_split(
    n: int, eu: np.ndarray, ev: np.ndarray, removed: Optional[list] = None
) -> Optional[np.ndarray]:
    """One Girvan-Newman split level over a graph of `n` nodes (local ids
    0..n-1 in first-appearance order) and edges (eu[i], ev[i]) in
    insertion order.  Returns int32 component labels, or None when the
    native library is unavailable.  ``removed``, if given, is extended
    by the removed edges' indices, in order of removal."""
    lib = _load()
    if lib is None:
        return None
    eu = np.ascontiguousarray(eu, dtype=np.int32)
    ev = np.ascontiguousarray(ev, dtype=np.int32)
    labels = np.empty(n, dtype=np.int32)
    gone = np.empty(len(eu) + 1, dtype=np.int64) if removed is not None \
        else None
    CALLS["gn_split"] += 1
    rc = lib.pt_gn_split(
        ctypes.c_int32(n),
        ctypes.c_int64(len(eu)),
        eu.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ev.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        None if gone is None else _i64(gone),
    )
    if rc != 0:
        return None
    if gone is not None:
        removed.extend(gone[:int(np.argmax(gone < 0))].tolist())
    return labels


def native_pyset_order(keys) -> Optional[np.ndarray]:
    """The iteration order of a CPython set filled with ``keys`` in turn,
    as ``pt_pyset_order`` replays it; None without the native core."""
    lib = _load()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    out = np.empty(len(keys), dtype=np.int64)
    n = lib.pt_pyset_order(_i64(keys), ctypes.c_int64(len(keys)), _i64(out))
    return out[:n]


def _pyset_probes():
    """Key lists that cross every growth of a small set (5, 19, 77 and
    307 keys fill tables of 8, 32, 128 and 512 slots) and collide on
    purpose: random ids below 10**6, multiples of table sizes, runs."""
    rng = np.random.default_rng(0)
    for size in (1, 4, 5, 6, 18, 19, 20, 65, 76, 77, 78, 150, 300, 306,
                 307, 308):
        yield rng.choice(10**6, size=size, replace=False)
    for step in (8, 32, 128, 512, 4096):
        yield np.arange(1, 300) * step
    yield np.arange(300)[::-1]
    yield rng.permutation(np.arange(10**5, 10**5 + 300))


_pyset_ok: Optional[bool] = None


def pyset_order_ok() -> bool:
    """Whether ``pt_pyset_order`` gives ``list(set(keys))``'s order on
    every probe list, in this process's CPython (checked once)."""
    global _pyset_ok
    if _pyset_ok is None:
        ok = native_available()
        for keys in _pyset_probes() if ok else ():
            keys = keys.tolist()
            got = native_pyset_order(keys)
            if got is None or got.tolist() != list(set(keys)):
                ok = False
                break
        _pyset_ok = ok
    return _pyset_ok


@dataclasses.dataclass
class GnFamilies:
    """``native_gn_families``' result: per component, its families (each
    a sorted list of ids), GN levels and own seconds; ``trace``, when
    asked for, per component the levels as (view order, removed edges as
    pairs of ids) in the order they ran."""

    families: List[List[List[int]]]
    levels: np.ndarray
    seconds: np.ndarray
    trace: Optional[List[list]] = None


def native_gn_families(
    n_total: int, members, member_off, eu, ev, edge_off, order_rank,
    seq_genome, n_threads: int, trace: bool = False,
) -> Optional[GnFamilies]:
    """Every colliding component's Girvan-Newman recursion in one call
    (``pt_gn_families``) on ``n_threads`` native threads, the GIL
    released throughout.  Component c: ids ``members[member_off[c]:
    member_off[c+1]]``, edges ``(eu[e], ev[e])`` for e in
    ``edge_off[c]:edge_off[c+1]`` in ``.net`` order.  None when the
    native library is unavailable or the call fails."""
    lib = _load()
    if lib is None:
        return None
    arrs = [np.ascontiguousarray(a, dtype=np.int64) for a in
            (members, member_off, eu, ev, edge_off, order_rank, seq_genome)]
    member_off, edge_off = arrs[1], arrs[4]
    n_comp = len(member_off) - 1
    if (len(edge_off) != n_comp + 1 or member_off[-1] != len(arrs[0])
            or edge_off[-1] != len(arrs[2]) or len(arrs[2]) != len(arrs[3])
            or len(arrs[5]) != len(arrs[6])):
        raise ValueError("native_gn_families: inconsistent array sizes")
    out_members = np.empty(len(arrs[0]), dtype=np.int64)
    out_sizes = np.empty(len(arrs[0]), dtype=np.int64)
    n_fam = np.zeros(n_comp, dtype=np.int64)
    levels = np.zeros(n_comp, dtype=np.int64)
    seconds = np.zeros(n_comp, dtype=np.float64)
    p_trace = ctypes.POINTER(ctypes.c_int64)()
    trace_len = ctypes.c_int64()
    CALLS["gn_families"] += 1
    rc = lib.pt_gn_families(
        n_comp, n_total, len(arrs[5]), *map(_i64, arrs),
        ctypes.c_int32(n_threads), _i64(out_members), _i64(out_sizes),
        _i64(n_fam), _i64(levels),
        seconds.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(p_trace) if trace else None,
        ctypes.byref(trace_len) if trace else None,
    )
    if rc != 0:
        return None
    mem, sizes = out_members.tolist(), out_sizes.tolist()
    families = []
    for c in range(n_comp):
        at = int(member_off[c])
        coms = []
        for size in sizes[at:at + int(n_fam[c])]:
            coms.append(mem[at:at + size])
            at += size
        families.append(coms)
    result = GnFamilies(families, levels, seconds)
    if trace:
        try:
            flat = np.frombuffer(ctypes.string_at(
                p_trace, 8 * trace_len.value), dtype=np.int64).tolist()
        finally:
            lib.pt_free(p_trace)
        result.trace = _levels(flat, levels.tolist())
    return result


def _levels(flat, levels):
    """``pt_gn_families``' trace, per component its ``levels[c]`` levels
    as (view order, removed edges as pairs of ids)."""
    out, at = [], 0
    for n_levels in levels:
        comp = []
        for _ in range(n_levels):
            k = flat[at]
            view = flat[at + 1:at + 1 + k]
            r = flat[at + 1 + k]
            pq = flat[at + 2 + k:at + 2 + k + 2 * r]
            at += 2 + k + 2 * r
            comp.append((tuple(view), [(view[p], view[q])
                                       for p, q in zip(pq[::2], pq[1::2])]))
        out.append(comp)
    return out

