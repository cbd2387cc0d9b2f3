"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pandelos_tpu_torch/csrc`` (lane2,
lane and pair joins), holds each against its plain PyTorch version on
the card on seeded random tables, on adversarial tables and pair lists
(chunk edges, tile-depth boundaries, empty and full rows, padding genes;
for the lane kernel also rows 128, 129 and 130 deep)
and at the shapes of the runs below,
checks the device division and the bound bits against the host, and
drives the engine (``.faa`` -> ``.net`` + ``.clus``, backend ``"cuda"``)
on ``bench_cache/mycoplasma64.faa`` at full size through each of its
paths: the default (lane2, device BBH; its allocation must stay within
``memory_model``), the cells path with the lane
kernel (host BBH), the roll join, and lane2's fallback on an input that
cannot pack (derived from mycoplasma64 with four seeded homopolymer
tracts); then the JAX package's kernel-free backends on mycoplasma64,
each of which must launch none of the join kernels: ``"xla"`` with
device BBH (the JAX package's default path), ``"xla"`` with the cells
path, and ``"dense"`` (before each, the device memory held must be back
at its level before the default path's run, with no garbage
collection); then the default path, xla and dense again under
``config.profile_dir`` (``torch.profiler``; each prints the card's busy
share and its top kernels); then mycoplasma16, the CLI's ``examples``
command over its four presets in a process of its own, and the
host-only ``"reference"`` backend on ``tests/golden/synth_real.faa``.
Then the multi-device paths on the one card: mycoplasma64 over four
shards on ``cuda:0`` (the ``devices=`` placement, the counterpart of the
JAX tests' virtual devices): the replicated engine (lane2, device BBH),
the ring with device BBH, the ring's cells path with the lane kernel,
``"xla"`` and the roll join (phase 22); each must run four shards,
launch its join kernel once a shard (none under xla) and allocate no
more than four times the memory model's per-device bytes, and the join
kernel of each ``"cuda"`` run is held bit for bit against its plain
version on the first shard's pair list (the ring's step-major one too);
it prints its per-shard pairs.  Then ``cli run --distributed`` in a
child process with PANDELOS_NUM_PROCS=1 (an NCCL group of one) on
mycoplasma16.  Last (phase 23), the option combinations that the JAX
package runs otherwise than asked, on mycoplasma16 (four shards where
the case has them): ``ring_extract`` under ``"xla"`` with device BBH and
on one shard under ``"cuda"`` (the replicated engine), the ring's cells
path under ``"xla"`` (the lane2 kernel, once a shard) and ``"dense"``
with the ring over four shards (the dense scorer), each with exactly the
launches its case implies; the lane2 kernel of cases b and c is held bit
for bit against its plain version on the first shard's pair list, and
the candidate engine's cases allocate no more than their shards times
the memory model's bytes.
In every run whose launches it counts, the flat pair fill kernel
(``csrc/flat_pairs.cu``) must have launched once for each join kernel
launch, as the spans' ``fill_launches`` counters say; phase 25 holds it
bit for bit against its plain twin and the ``torch.cummax`` form it
replaced (edge and tile cases, two heavy chunks at the benchmark cells'
shapes, the main path's list of phase 6) and times it.
Every output must be byte-identical to its committed golden (the derived
input's two runs to each other; the examples' generated ``.faa`` too).
Phases print one line each; a ``kernels`` JSON line comes before the
last line, and the last line is the result object.  Any failure exits
non-zero without a result; so does a machine without a card, and a
directory without the package.

    python3 chip_smoke.py --kernels-only

stops after the kernel checks (build, random and adversarial tables,
phase 24: the k-mer index build at the benchmark cells' shapes, against
the NumPy build and its plain version, timed, and phase 25's fill cases
and heavy chunks) and prints no result line: the short first call after
a kernel changed.

The multi-device paths elsewhere: on the CPU, ``python -m
pandelos_tpu_torch.cli run in.faa out --device cpu --devices 4 [--ring]``
runs four CPU shards, and two processes of ``... --device cpu --devices 4
--distributed`` with PANDELOS_COORDINATOR=127.0.0.1:PORT,
PANDELOS_NUM_PROCS=2 and PANDELOS_PROC_ID=0 / 1 a gloo group of two
processes with two shards each; on four cards of one host, ``python -m
pandelos_tpu_torch.probe_multigpu`` runs mycoplasma64 over ``cuda:0..3``
in one process and in four NCCL processes, with and without the ring.
"""

from __future__ import annotations

import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, "bench_cache")
MAIN = "mycoplasma64"
MAIN_TARGETS = {"n_cells": 2_004_000, "edges": 938_741, "families": 1_607}
PRESETS = ["mycoplasma16"]
# the presets of the CLI's examples command (its default)
EXAMPLES = ["salmonella7", "escherichia10", "xanthomonas14", "mycoplasma64"]
# cuBLAS and CUTLASS matrix-multiply kernels, by name
MATMUL_KERNEL = re.compile(r"gemm|nvjet|xmma|cutlass", re.IGNORECASE)
# H100 SXM published peaks (NVIDIA data sheet, 700 W); the guide's table
# has no int32 row, so int32 compare-and-add work is held to the CUDA
# cores' f32 rate (the same cores issue int32 ops)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12
# device memory held between runs may differ from its level before the
# main path by no more than this
HELD_SLACK_BYTES = 0.25e9


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def random_profiles(seed, n_genes=3000, vocab=4096, max_count=256,
                    id_base=0):
    """Seeded padded profiles [G_pad, W] (the pad_profiles layout: ids
    are ``id_base`` plus distinct sorted draws below ``vocab``, counts in
    [1, max_count), padding id ``id_base + vocab`` and count 0) with lane
    depths up to vocab/128: empty profiles, full-width rows and eight
    all-padding genes.  Returns (ids, counts, dg, rng)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    G_pad = n_genes + 8
    widths = rng.integers(0, vocab + 1, size=n_genes)
    widths[rng.random(n_genes) < 0.1] = 0  # empty profiles
    widths[:4] = vocab  # full depth
    W = int(-(-widths.max() // 128) * 128)
    ids = np.full((G_pad, W), id_base + vocab, np.int32)
    cnt = np.zeros((G_pad, W), np.int32)
    dg = np.zeros(G_pad, np.int32)
    for g, w in enumerate(widths):
        v = id_base + np.sort(rng.choice(vocab, size=w, replace=False))
        ids[g, :w] = v
        cnt[g, :w] = rng.integers(1, max_count, size=w)
        if w:
            dg[g] = np.bincount(v & 127, minlength=128).max()
    return ids, cnt, dg, rng


def random_pairs(rng, G_pad, n_genes, device, n_pairs=1 << 16):
    """Seeded pair lists: a == b for a sixteenth, the padding gene for the
    last 64."""
    import torch

    a = rng.integers(0, G_pad, size=n_pairs).astype("int32")
    b = rng.integers(0, G_pad, size=n_pairs).astype("int32")
    b[: n_pairs // 16] = a[: n_pairs // 16]  # a == b
    a[-64:] = n_genes  # padding gene, depth 0
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def random_join_inputs(kind, device, seed):
    """Arguments of one join wrapper on seeded random tables: ``lane2``
    packs counts below 256; ``lane`` and ``roll`` take counts up to 999
    and ids above 2^23, which lane2 cannot pack."""
    import torch

    from pandelos_tpu_torch.ops.lane_join import pack_lane_device_core
    from pandelos_tpu_torch.ops.pair_join import pack_profiles

    wide = kind != "lane2"
    ids, cnt, dg, rng = random_profiles(
        seed, max_count=1000 if wide else 256,
        id_base=(1 << 23) + 5 if wide else 0,
    )
    ids_d = torch.from_numpy(ids).to(device)
    cnt_d = torch.from_numpy(cnt).to(device)
    a, b = random_pairs(rng, ids.shape[0], ids.shape[0] - 8, device)
    if kind == "roll":
        return (pack_profiles(ids_d, cnt_d), a, b)
    D = max(1, int(dg.max()))
    table = pack_lane_device_core(ids_d, cnt_d, D, packed=not wide)
    return (table, torch.from_numpy(dg).to(device), a, b)


def adversarial_profiles(seed, vocab=4096, n_random=24, max_count=256,
                         id_base=0):
    """Seeded padded profiles [G_pad, W = vocab] (the pad_profiles
    layout) made to sit on the join kernels' edges.  ``vocab`` is a
    multiple of 128.  Rows: an empty profile; a full-width one (every
    lane at depth vocab/128, no count-0 slot); a single id; where they
    fit, rows whose lane depth is exactly 4, 5, 8, 9, 16 and 17 (lane2's
    register tile, the depth it keeps in shared memory per row, twice
    that, and one past each); ``n_random`` rows of random width;
    then four all-padding genes.  Counts lie in [1, max_count) with both
    ends present.  Returns (ids, counts, dg, n_genes, rng)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    rows = [np.zeros(0, np.int64), np.arange(vocab), np.array([vocab // 2])]
    rows += [np.arange(n) for n in (512, 513, 1024, 1025, 2048, 2049)
             if n <= vocab]
    for _ in range(n_random):
        w = int(rng.integers(1, vocab + 1))
        rows.append(np.sort(rng.choice(vocab, size=w, replace=False)))
    n_genes = len(rows)
    G_pad = n_genes + 4
    ids = np.full((G_pad, vocab), id_base + vocab, np.int32)
    cnt = np.zeros((G_pad, vocab), np.int32)
    dg = np.zeros(G_pad, np.int32)
    for g, v in enumerate(rows):
        w = len(v)
        ids[g, :w] = id_base + v
        cnt[g, :w] = rng.integers(1, max_count, size=w)
        cnt[g, :w:7] = max_count - 1
        cnt[g, 1:w:7] = 1
        if w:
            dg[g] = np.bincount(v & 127, minlength=128).max()
    return ids, cnt, dg, n_genes, rng


def adversarial_pairs(rng, n_genes, G_pad):
    """Pair lists (label, a, b) over genes [0, n_genes) and the padding
    genes [n_genes, G_pad): runs of one a whose lengths straddle the
    32-pair chunk, an a that changes at every pair, a == b, every pair
    of the first nine (special) rows, the padding gene on either side
    and both, and lists shorter than, equal to and just past a chunk."""
    import numpy as np

    def i32(x):
        return np.asarray(x, np.int32)

    lens = [1, 31, 32, 33, 64, 100, 5, 27]  # sums to 293: not a chunk multiple
    run_a = rng.integers(0, n_genes, size=len(lens))
    runs = np.repeat(run_a, lens)
    yield "runs across chunk edges", i32(runs), i32(
        rng.integers(0, n_genes, size=len(runs)))
    n = 333
    yield "a changes at every pair", i32(np.arange(n) % n_genes), i32(
        rng.integers(0, n_genes, size=n))
    every = np.arange(G_pad)
    yield "a == b", i32(every), i32(every)
    sp = min(9, n_genes)
    aa, bb = np.meshgrid(np.arange(sp), np.arange(sp), indexing="ij")
    yield "special rows, all pairs", i32(aa.ravel()), i32(bb.ravel())
    real = rng.integers(0, n_genes, size=40)
    pad = np.full(40, n_genes)
    yield "padding gene as a, as b, as both", i32(
        np.concatenate([pad, real, pad])), i32(
        np.concatenate([real, pad + 1, pad]))
    for n in (1, 31, 32, 33):
        yield f"{n} pairs", i32(rng.integers(0, n_genes, size=n)), i32(
            rng.integers(0, n_genes, size=n))


def adversarial_join_cases(kind, device, seed):
    """(label, wrapper arguments) for one join kernel over two
    adversarial tables: vocabulary 4096 (lane depth to 32, W = 4096) and
    128 (D = 1, W = 128)."""
    import torch

    from pandelos_tpu_torch.ops.lane_join import pack_lane_device_core
    from pandelos_tpu_torch.ops.pair_join import pack_profiles

    wide = kind != "lane2"
    for vocab in (4096, 128):
        ids, cnt, dg, n_genes, rng = adversarial_profiles(
            seed, vocab=vocab, max_count=1000 if wide else 256,
            id_base=(1 << 23) + 5 if wide else 0)
        ids_d = torch.from_numpy(ids).to(device)
        cnt_d = torch.from_numpy(cnt).to(device)
        if kind == "roll":
            head = (pack_profiles(ids_d, cnt_d),)
        else:
            head = (pack_lane_device_core(ids_d, cnt_d, max(1, int(dg.max())),
                                          packed=not wide),
                    torch.from_numpy(dg).to(device))
        for label, a, b in adversarial_pairs(rng, n_genes, ids.shape[0]):
            yield f"vocab {vocab}, {label}", head + (
                torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


def deep_profiles(seed, max_count=1000, id_base=(1 << 23) + 5):
    """Seeded padded profiles (the pad_profiles layout) whose lane depths
    pass 128, the depths that one block of the lane kernel's b loop can
    name: a row with every lane exactly 128 deep, rows 129 and 130 deep
    in a few lanes, two half-filled random rows whose shared ids sit at
    different depths than in the deep rows, a single id, an empty
    profile; then two all-padding genes.  ``id_base`` is a multiple of
    128 plus 5, so lanes are rotated.  Returns (ids, counts, dg,
    n_genes, rng)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    k = np.arange(256)

    def lanes(depths):  # {lane: its ranks k} -> sorted ids
        return np.sort(np.concatenate(
            [lane + 128 * np.asarray(ks) for lane, ks in depths.items()]))

    rows = [
        lanes({lane: k[:128] for lane in range(128)}),
        lanes({0: k[:129], 5: k[:129], 127: k[:100], 64: k[:1]}),
        lanes({3: k[:130], 0: k[50:179], 127: k[:128], 9: k[::2]}),
        lanes({0: k[100:230], 3: k[1:130:2], 126: k[:129]}),
        np.flatnonzero(rng.random(130 * 128) < 0.5),
        np.flatnonzero(rng.random(130 * 128) < 0.5),
        np.array([129 * 128 + 3]),
        np.zeros(0, np.int64),
    ]
    n_genes = len(rows)
    G_pad = n_genes + 2
    vocab = 256 * 128
    W = -(-max(len(v) for v in rows) // 128) * 128
    ids = np.full((G_pad, W), id_base + vocab, np.int32)
    cnt = np.zeros((G_pad, W), np.int32)
    dg = np.zeros(G_pad, np.int32)
    for g, v in enumerate(rows):
        w = len(v)
        ids[g, :w] = id_base + v
        cnt[g, :w] = rng.integers(1, max_count, size=w)
        cnt[g, :w:7] = max_count - 1
        if w:
            dg[g] = np.bincount((id_base + v) & 127, minlength=128).max()
    return ids, cnt, dg, n_genes, rng


def deep_pairs(rng, n_genes, G_pad):
    """A short pair list over the deep rows: every pair of them (so each
    a comes as a run), then a == b and a padding gene."""
    import numpy as np

    aa, bb = np.meshgrid(np.arange(n_genes), np.arange(n_genes),
                         indexing="ij")
    a = np.concatenate([aa.ravel(), np.arange(G_pad), [n_genes, 0]])
    b = np.concatenate([bb.ravel(), np.arange(G_pad), [1, n_genes + 1]])
    return a.astype(np.int32), b.astype(np.int32)


def deep_join_case(device, seed):
    """Wrapper arguments of the lane kernel on the deep rows (lane depths
    128, 129 and 130: D = 130)."""
    import torch

    from pandelos_tpu_torch.ops.lane_join import pack_lane_device_core

    ids, cnt, dg, n_genes, rng = deep_profiles(seed)
    table = pack_lane_device_core(
        torch.from_numpy(ids).to(device), torch.from_numpy(cnt).to(device),
        int(dg.max()), packed=False)
    a, b = deep_pairs(rng, n_genes, ids.shape[0])
    return (table, torch.from_numpy(dg).to(device),
            torch.from_numpy(a).to(device), torch.from_numpy(b).to(device))


def _bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CORE_OPS_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations"


def lane_bound_ms(dg, pi, pj, slot_bytes):
    """Least time for a lane join on these inputs, the larger of two:
    its bytes (each table row that a pair names read once up to its
    depth, ``slot_bytes`` per slot row: 512 packed, 1024 unpacked; the
    depths, the pair indices, the three outputs) at HBM rate, and its
    compare-and-add steps (dg[a] * dg[b] * 128 per pair) at the CUDA
    cores' rate.  Also returns the time of the per-pair row traffic
    ((dg[a] + dg[b]) * slot_bytes per pair at HBM rate), what the kernel
    moves when no row is reused from cache."""
    import torch

    a, b = pi.long(), pj.long()
    da, db = dg[a].double(), dg[b].double()
    rows = torch.unique(torch.cat([a, b]))
    n = pi.shape[0]
    nbytes = float(dg[rows].double().sum()) * slot_bytes + rows.numel() * 4
    t, by = _bound(nbytes + n * 20, float((da * db * 128).sum()))
    t_pair = float(((da + db) * slot_bytes).sum()) / HBM_BYTES_PER_S * 1e3
    return t, by, t_pair


def pair_bound_ms(table, pi, pj):
    """Least time for the pair join on these inputs, the larger of its
    bytes (each named row read once up to its width, 8 bytes an entry;
    the pair indices and the three outputs) at HBM rate and its merge
    steps (w_a + w_b per pair) at the CUDA cores' rate; also the time of
    the per-pair row traffic ((w_a + w_b) * 8 bytes per pair)."""
    import torch

    W = table.shape[1] // 2
    w = (table[:, W:] > 0).sum(1).double()
    a, b = pi.long(), pj.long()
    rows = torch.unique(torch.cat([a, b]))
    n = pi.shape[0]
    steps = float((w[a] + w[b]).sum())
    t, by = _bound(float(w[rows].sum()) * 8 + n * 20, steps)
    return t, by, steps * 8 / HBM_BYTES_PER_S * 1e3


# join kernel -> (wrapper name, its module, plain version, CUDA source,
# the TPU kernel it replaces)
JOINS = {
    "lane2": ("lane2_join", "lane_join", "lane2_join_plain",
              "lane2_join.cu", "pandelos_tpu/ops/lane_join.py:416"),
    "lane": ("lane_join", "lane_join", "lane_join_plain",
             "lane_join.cu", "pandelos_tpu/ops/lane_join.py:235"),
    "roll": ("join_pairs_core", "pair_join", "join_pairs_plain",
             "pair_join.cu", "pandelos_tpu/ops/pallas_join.py:56"),
}


def join_fns(kind):
    import importlib

    wrapper, mod, plain, _, _ = JOINS[kind]
    m = importlib.import_module(f"pandelos_tpu_torch.ops.{mod}")
    return getattr(m, wrapper), getattr(m, plain)


def bound_of(kind, args):
    if kind == "roll":
        return pair_bound_ms(*args)
    return lane_bound_ms(args[1], args[2], args[3],
                         512 if kind == "lane2" else 1024)


def launches():
    return {k: join_fns(k)[0].launches for k in JOINS}


def zero_launches():
    """The join kernels' launch counters and the fill kernel's, to 0."""
    from pandelos_tpu_torch.ops.flat_pairs import flat_pairs

    for k in JOINS:
        join_fns(k)[0].launches = 0
    flat_pairs.launches = 0


def check_join(kind, name, args, plain_chunk):
    """The kernel against its plain version on the same inputs, bit for
    bit; returns (max abs error, plain ms, kernel ms, bound ms, what sets
    the bound, per-pair row traffic ms)."""
    import torch

    kernel, plain = join_fns(kind)
    got = kernel(*args)
    torch.cuda.synchronize()
    t = time.monotonic()
    want = plain(*args, pair_chunk=plain_chunk)
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t) * 1e3
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    for g, w in zip(got, want):
        if not torch.equal(g, w):
            raise AssertionError(
                f"{name}: {kind} kernel != plain (max err {err})")
    ms = cuda_ms(lambda: kernel(*args), reps=5)
    bound, by, pair_ms = bound_of(kind, args)
    return err, plain_ms, ms, bound, by, pair_ms


def check_captured(kind, cap, name, ph=3):
    """The kernel at the shapes a run gave it (a sharded run's: its first
    shard's): its rerun equals the run's counters, and check_join on the
    run's inputs."""
    import torch

    if cap["join_kernel"] != kind:
        raise AssertionError(f"{name}: joined with {cap['join_kernel']}")
    args = ((cap["table"], cap["pi"], cap["pj"]) if kind == "roll" else
            (cap["table"], cap["dg"], cap["pi"], cap["pj"]))
    for label, a, b in zip(("inter", "perc", "tr"),
                           (cap["inter"], cap["perc"], cap["tr"]),
                           join_fns(kind)[0](*args)):
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: {kind} rerun differs in {label}")
    r = check_join(kind, name, args, plain_chunk=1 << 14 if kind == "roll"
                   else 1 << 17)
    log(ph, f"{kind} at {name} shapes (table {tuple(args[0].shape)}, P "
        f"{args[-1].shape[0]}): bit-equal to plain; kernel {r[2]:.4f} ms, "
        f"plain {r[1]:.1f} ms, bound {r[3]:.4f} ms ({r[4]}), per-pair row "
        f"traffic {r[5]:.4f} ms")
    return r


def check_memory_model(ph, index, cfg, K, allocated, dev, pair_cap=None):
    """The memory model that check_hbm_fit reads, at the candidate cap
    ``K`` that a run reached (and, for the cuda backend, its flat pair
    list's ``pair_cap``), must hold the bytes the run allocated."""
    from pandelos_tpu_torch.config import PipelineConfig
    from pandelos_tpu_torch.ops.candidate import memory_model

    config = PipelineConfig(**cfg)
    mm = memory_model(index, config, device=dev, cand_cap=K,
                      pair_cap=pair_cap)
    if allocated > mm["total_bytes"]:
        raise AssertionError(f"{cfg}: {allocated} bytes allocated past the "
                             f"memory model's {mm['total_bytes']}")
    at_k = memory_model(index, config, device=dev, cand_cap=K)["total_bytes"]
    top = memory_model(index, config, device=dev)["total_bytes"]
    log(ph, f"{cfg}: memory model {mm['total_bytes'] / 1e9:.2f} GB at K {K}"
        f"{f', pair_cap {pair_cap}' if pair_cap else ''} (candidate work "
        f"{mm['join_temp_bytes'] / 1e9:.2f} GB, bound bits "
        f"{mm['bound_bits_bytes'] / 1e9:.2f} GB, signatures "
        f"{mm['sig_bytes'] / 1e9:.2f} GB) holds the {allocated / 1e9:.2f} GB "
        f"allocated; {at_k / 1e9:.2f} GB at K {K} with any pair list; "
        f"{top / 1e9:.2f} GB at the largest cap")


def run(name, outdir, capture=None, golden=None, tag="", dataset=None,
        devices=None, **config):
    """One run_pipeline on the card (backend "cuda" unless ``config``
    names another; ``devices``: the shards' placement); its .net and
    .clus must be byte-identical to ``golden`` (a path prefix; default
    the preset's ``bench_cache`` files; ``False``: no golden)."""
    from pandelos_tpu_torch.config import PipelineConfig
    from pandelos_tpu_torch.pipeline import run_pipeline

    prefix = os.path.join(outdir, name + tag)
    if golden is None:
        golden = os.path.join(CACHE, name)
    t = time.monotonic()
    res = run_pipeline(
        os.path.join(CACHE, name + ".faa"), prefix,
        PipelineConfig(**{"backend": "cuda", "device": "cuda", **config}),
        dataset=dataset, capture=capture, devices=devices,
    )
    wall = time.monotonic() - t
    same = {
        s: golden is False or filecmp.cmp(prefix + s, golden + s,
                                          shallow=False)
        for s in (".net", ".clus")
    }
    if not all(same.values()):
        raise AssertionError(f"{name}{tag}: outputs differ from {golden}: "
                             f"{same}")
    return res, wall, prefix


def check_targets(name, res):
    got = {"n_cells": res.stats["network"]["n_cells"],
           "edges": len(res.edges), "families": res.stats["n_families"]}
    if got != MAIN_TARGETS:
        raise AssertionError(f"{name}: {got} != {MAIN_TARGETS}")
    return got


def homopolymer_dataset(seed=10, n_tracts=4, length=300):
    """mycoplasma64 with a seeded homopolymer tract (poly-Q or poly-N) of
    ``length`` residues appended to ``n_tracts`` proteins of different
    genomes: its 6-mer counts reach length - 5 >= 256, which lane2
    cannot pack.  Returns (dataset, the tract proteins' indices)."""
    import numpy as np

    from pandelos_tpu_torch.io.faa import read_faa

    ds = read_faa(os.path.join(CACHE, MAIN + ".faa"))
    rng = np.random.default_rng(seed)
    genomes = rng.choice(ds.n_genomes, size=n_tracts, replace=False)
    sets = ds.genome_sets()
    rows = sorted(int(rng.choice(sets[g])) for g in genomes)
    for r in rows:
        ds.sequences[r] += str(rng.choice(list("QN"))) * length
    return ds, rows


# phase -> (tag, config) of the four-shard runs on one card
SHARDED = {
    17: ("_4shards", dict()),
    18: ("_4ring", dict(ring_extract=True)),
    19: ("_4ring_cells_lane", dict(ring_extract=True, device_bbh=False,
                                    join_kernel="lane")),
    20: ("_4xla", dict(backend="xla")),
    22: ("_4roll", dict(join_kernel="roll")),
}
N_SHARDS = 4


def sharded_phases(dev, outdir):
    """Phases 17-20 and 22: mycoplasma64 at full size over four shards on
    the card.  Each must write the goldens, run four shards (the kernel of
    its path launched once a shard, none under xla), and allocate no
    more than the memory model's per-device bytes times the four shards
    on the card (an upper bound: the shards share the replicated
    tensors); the kernel of each cuda path is then held bit for bit
    against its plain version on the first shard's pair list (a shard's
    list; the ring's is step-major).  Prints each run's wall, phases
    and per-shard pairs."""
    import numpy as np
    import torch

    from pandelos_tpu_torch.config import PipelineConfig
    from pandelos_tpu_torch.ops.candidate import memory_model

    torch.cuda.init()
    for ph, (tag, cfg) in SHARDED.items():
        cfg = dict(cfg, n_devices=N_SHARDS)
        cap = {}
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        res, wall, _ = run(MAIN, outdir, capture=cap, tag=tag,
                           devices=[dev] * N_SHARDS, **cfg)
        n = launches()
        fills = check_fills(f"phase {ph}", res, n)
        peak = torch.cuda.max_memory_allocated(dev) - held
        got = check_targets(MAIN, res)
        net = res.stats["network"]
        kernel = None if cfg.get("backend") == "xla" else cap["join_kernel"]
        want = {k: N_SHARDS if k == kernel else 0 for k in JOINS}
        if n != want:
            raise AssertionError(f"phase {ph}: launches {n}, want {want}")
        if kernel is not None:
            check_captured(kernel, cap, f"phase {ph} shard 0", ph)
        pairs = np.asarray(cap["pairs_per_shard"])
        if len(pairs) != N_SHARDS or net.get("n_devices", N_SHARDS) != \
                N_SHARDS:
            raise AssertionError(f"phase {ph}: {len(pairs)} shards ran")
        K = net.get("candidate_cap_final", PipelineConfig().candidate_cap)
        pair_cap = net.get("pair_cap", cap.get("pair_cap"))
        config = PipelineConfig(**{"backend": "cuda", **cfg})
        mm = memory_model(cap["runner"].index, config, device=dev,
                          cand_cap=K, pair_cap=pair_cap)
        if peak > N_SHARDS * mm["total_bytes"]:
            raise AssertionError(
                f"phase {ph}: {peak} bytes allocated past {N_SHARDS} x the "
                f"memory model's {mm['total_bytes']}")
        log(ph, f"{MAIN} {cfg} on {N_SHARDS} shards of {dev}: .net/.clus "
            f"byte-identical to golden; {got}; launches {n}, flat_pairs "
            f"{fills}; wall {wall:.2f}s")
        log(ph, "phase_times " + json.dumps(
            {k: round(v, 4) for k, v in res.phase_times.items()}))
        if "phase_s" in net:
            log(ph, "device phases " + json.dumps(net["phase_s"]))
        log(ph, f"pairs per shard {pairs.tolist()}: max/mean "
            f"{pairs.max() / max(1.0, pairs.mean()):.4f}; K {K}, pair_cap "
            f"{pair_cap}")
        log(ph, f"peak device memory {peak / 1e9:.2f} GB over the "
            f"{held / 1e9:.2f} GB held; memory model "
            f"{mm['total_bytes'] / 1e9:.2f} GB a device (x{N_SHARDS} = "
            f"{N_SHARDS * mm['total_bytes'] / 1e9:.2f} GB)")
        if cfg.get("ring_extract"):
            rep = memory_model(cap["runner"].index, config, device=dev,
                               cand_cap=K, pair_cap=pair_cap, ring=False)
            G_pad, B = mm["padded_genes"], mm["signature_buckets"]
            log(ph, f"column signatures a shard [{G_pad // N_SHARDS}, {B}] "
                f"bf16 = {2 * G_pad // N_SHARDS * B / 1e9:.4f} GB, the "
                f"replicated engine's [{G_pad}, {B}] = "
                f"{2 * G_pad * B / 1e9:.4f} GB; all signature bytes a "
                f"shard in the model: ring {mm['sig_bytes'] / 1e9:.2f} GB, "
                f"replicated {rep['sig_bytes'] / 1e9:.2f} GB; model a "
                f"device: ring {mm['ring_bytes_per_device'] / 1e9:.2f} GB, "
                f"replicated {rep['replicated_bytes_per_device'] / 1e9:.2f}"
                f" GB")
        del cap, res
        torch.cuda.empty_cache()


# phase 23: option combinations that the JAX package runs otherwise than
# asked, as it runs them: (label, config, shards, launches, the device
# BBH's ring_extract (None: the cells path, which does not report it),
# the memory model's ring argument for the engine that runs (None: the
# dense scorer, which the model does not cover))
COMBINATIONS = (
    ("a: xla + ring, 4 shards, device BBH: the replicated xla engine",
     dict(backend="xla", ring_extract=True, device_bbh=True), N_SHARDS, {},
     False, False),
    ("b: cuda + ring, one shard, device BBH: the replicated engine",
     dict(ring_extract=True, n_devices=1, device_bbh=True), None,
     {"lane2": 1}, False, False),
    ("c: xla + ring, 4 shards, cells path: the ring with the lane2 kernel",
     dict(backend="xla", ring_extract=True, device_bbh=False), N_SHARDS,
     {"lane2": N_SHARDS}, None, True),
    ("e: dense + ring, 4 shards: the dense scorer",
     dict(backend="dense", ring_extract=True), N_SHARDS, {}, None, None),
)


def combination_phase(dev, outdir):
    """Phase 23: the combinations of COMBINATIONS on mycoplasma16, four
    shards on the card where the case has them: each .net/.clus
    byte-identical to phase 7's (the preset's goldens), with exactly the
    launches the case implies and the ring_extract it reports; the
    kernel a case launches is held bit for bit against its plain version
    on the first shard's pair list, and a case on the candidate engine
    allocates no more than its shards times the memory model's bytes."""
    import torch

    from pandelos_tpu_torch.config import PipelineConfig
    from pandelos_tpu_torch.ops.candidate import memory_model

    name = PRESETS[0]
    for i, (label, cfg, n_shards, want, ring, model_ring) in enumerate(
            COMBINATIONS):
        devices = None
        if n_shards:
            cfg = dict(cfg, n_devices=n_shards)
            devices = [dev] * n_shards
        cap = {}
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        res, wall, _ = run(name, outdir, capture=cap, tag=f"_combo{i}",
                           devices=devices, **cfg)
        n = launches()
        fills = check_fills(f"phase 23 {label}", res, n)
        peak = torch.cuda.max_memory_allocated(dev) - held
        full = {k: want.get(k, 0) for k in JOINS}
        if n != full:
            raise AssertionError(f"phase 23 {label}: launches {n}, want "
                                 f"{full}")
        net = res.stats["network"]
        if net.get("ring_extract") != ring:
            raise AssertionError(f"phase 23 {label}: ring_extract "
                                 f"{net.get('ring_extract')}, want {ring}")
        pairs = cap.get("pairs_per_shard")
        if model_ring is not None and len(pairs) != (n_shards or 1):
            raise AssertionError(f"phase 23 {label}: {len(pairs)} shards "
                                 f"ran")
        log(23, f"{name} {label} ({cfg}): .net/.clus byte-identical to "
            f"phase 7's; launches {n}, flat_pairs {fills}; ring_extract "
            f"{net.get('ring_extract')}"
            f", n_devices {net.get('n_devices')}; wall {wall:.2f}s; "
            f"phase_times " + json.dumps(
                {k: round(v, 4) for k, v in res.phase_times.items()}))
        if want:
            check_captured(next(iter(want)), cap, f"phase 23 {label[:1]} "
                           f"shard 0", 23)
        if model_ring is not None:
            config = PipelineConfig(**{"backend": "cuda", **cfg})
            K = net.get("candidate_cap_final", config.candidate_cap)
            pair_cap = net.get("pair_cap", cap.get("pair_cap"))
            mm = memory_model(cap["runner"].index, config, device=dev,
                              cand_cap=K, pair_cap=pair_cap,
                              ring=model_ring)
            bound = (n_shards or 1) * mm["total_bytes"]
            if peak > bound:
                raise AssertionError(
                    f"phase 23 {label}: {peak} bytes allocated past "
                    f"{n_shards or 1} x the memory model's "
                    f"{mm['total_bytes']}")
            log(23, f"{label[:1]}: pairs per shard {list(map(int, pairs))}; "
                f"peak device memory {peak / 1e9:.3f} GB over the "
                f"{held / 1e9:.2f} GB held; memory model (ring "
                f"{model_ring}, K {K}, pair_cap {pair_cap}) "
                f"{mm['total_bytes'] / 1e9:.3f} GB a device (x"
                f"{n_shards or 1} = {bound / 1e9:.3f} GB)")
        del cap, res
        torch.cuda.empty_cache()


def distributed_phase(outdir):
    """Phase 21: ``cli run --distributed`` with PANDELOS_NUM_PROCS=1 in a
    child process, an NCCL process group of one on the card, on
    mycoplasma16: byte-identical to its golden."""
    import socket

    name = PRESETS[0]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PANDELOS_COORDINATOR=f"127.0.0.1:{port}",
               PANDELOS_NUM_PROCS="1", PANDELOS_PROC_ID="0")
    prefix = os.path.join(outdir, name + "_dist")
    t = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "pandelos_tpu_torch.cli", "run",
         os.path.join(CACHE, name + ".faa"), prefix, "--distributed"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.monotonic() - t
    if proc.returncode != 0:
        raise AssertionError(f"cli run --distributed exited "
                             f"{proc.returncode}: {proc.stderr[-3000:]}")
    topo = json.loads(next(line for line in proc.stderr.splitlines()
                           if line.startswith('{"distributed"')))
    out = json.loads(proc.stdout)
    for suffix in (".net", ".clus"):
        if not filecmp.cmp(prefix + suffix, os.path.join(CACHE, name + suffix),
                           shallow=False):
            raise AssertionError(f"--distributed: {name}{suffix} differs")
    log(21, f"{name} cli run --distributed (NCCL, one process): .net/.clus "
        f"byte-identical to golden; topology {topo['distributed']}; "
        f"n_devices {out['stats']['network']['n_devices']}; process wall "
        f"{wall:.2f}s; phase_times " + json.dumps(
            {k: round(v, 4) for k, v in out["phase_times"].items()}))


# phase 24: the k-mer index build at the benchmark cells' shapes
INDEX_SHAPES = ["mycoplasma64", "xanthomonas14", "xanthomonas14_annotated"]
# kernels of csrc/kmer_index.cu, by name in a profiler trace
INDEX_KERNEL = re.compile(r"\bk_(census|windows|keys|radix_hist|radix_scatter|"
                          r"scan_one_block|flag_count|flag_emit|counts|"
                          r"gather)\b")


def _index_device_ms(fn):
    """Device ms of the index kernels and of the copies in one call of
    ``fn`` (``torch.profiler``); (None, None) where the trace shows no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = copy = 0.0
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = getattr(ev, "cuda_time_total", 0.0)
        if INDEX_KERNEL.search(ev.key):
            kern += us
        elif "Memcpy" in ev.key:
            copy += us
    if kern == 0:
        return None, None
    return kern / 1e3, copy / 1e3


def index_phase(dev):
    """Phase 24: ``csrc/kmer_index.cu`` at the shapes of the benchmark's
    three cells (their generators' datasets, k by the entropy rule):
    bit-equal to the plain version run on the card and to the NumPy
    build (``index.py``, the JAX package's index algorithm, which the
    CPU tests hold equal to it); the wrapper's wall (kernels, three
    waits, the copies back), the kernels' and copies' device time in a
    profiler trace, the plain version's and the NumPy build's wall, and
    the least time of the bytes (the residues and offsets read once, the
    CSR pointer, costs, ids and counts written once, at 3.35 TB/s)."""
    import numpy as np
    import torch

    from pandelos_tpu_torch.bench.synth import SynthSpec, generate
    from pandelos_tpu_torch.index import _encode_sequences, _numpy_index
    from pandelos_tpu_torch.ksel import select_k
    from pandelos_tpu_torch.ops import kmer_index as ki

    rows = []
    for name in INDEX_SHAPES:
        with open(os.path.join(ROOT, "benchmark", "configs",
                               name + ".json")) as fh:
            spec = SynthSpec(**json.load(fh)["generator"])
        seqs = generate(spec).sequences
        k = select_k(seqs)
        concat, offsets, lengths = _encode_sequences(seqs)
        t = time.perf_counter()
        host = _numpy_index(concat, offsets, k,
                            np.maximum(lengths - k + 1, 0))
        host_ms = (time.perf_counter() - t) * 1e3
        c = torch.tensor(concat).to(dev)
        o = torch.from_numpy(offsets).to(dev)
        launches0 = ki.kmer_index.launches
        got = ki.kmer_index(c, o, k)
        torch.cuda.synchronize()
        n_launch = ki.kmer_index.launches - launches0
        t = time.perf_counter()
        plain = ki.kmer_index_plain(c, o, k)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        err = 0
        for other, what in ((host, "NumPy build"), (plain, "plain")):
            for a, b in zip(got, other):
                if isinstance(a, np.ndarray):
                    if a.dtype != b.dtype or a.shape != b.shape:
                        raise AssertionError(f"kmer_index != {what} at "
                                             f"{name}: dtype or shape")
                    d = (int(np.abs(a.astype(np.int64)
                                    - b.astype(np.int64)).max())
                         if a.size else 0)
                else:
                    d = abs(a - b)
                err = max(err, d)
            if err:
                raise AssertionError(f"kmer_index != {what} at {name}: "
                                     f"max abs err {err}")
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ki.kmer_index(c, o, k)
            walls.append((time.perf_counter() - t) * 1e3)
        kern_ms, copy_ms = _index_device_ms(lambda: ki.kmer_index(c, o, k))
        G = len(offsets) - 1
        nnz = int(got[1].shape[0])
        nbytes = len(concat) + 8 * (G + 1) + 8 * (G + 1) + 8 * G + 8 * nnz
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        windows = int(np.maximum(np.diff(offsets) - k + 1, 0).sum())
        log(24, f"kmer_index {name} (k {k}, genes {G}, windows {windows}, "
            f"nnz {nnz}, total_vocab {got[5]}, vocab_size {got[4]}): "
            f"bit-equal to the NumPy build and to plain; kernels "
            f"{kern_ms} ms, copies {copy_ms} ms (device), wrapper wall "
            f"median {sorted(walls)[2]:.3f} ms of {walls}, {n_launch} "
            f"launches; bound {bound_ms:.4f} ms (bytes); plain on the "
            f"card {plain_ms:.1f} ms; NumPy build {host_ms:.1f} ms")
        rows.append({
            "name": "kmer_index", "shape": name, "route": "cuda",
            "source": "pandelos_tpu_torch/csrc/kmer_index.cu",
            "replaces": "ig/native/library.cpp:189-371 (no TPU kernel)",
            # launches: the main path's (phase 6, one build of MAIN)
            "launches": None, "launches_per_build": n_launch,
            "max_abs_err": err, "ms": kern_ms,
            "copy_ms": copy_ms, "wall_ms": sorted(walls)[2],
            "plain_ms": plain_ms, "host_ms": host_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None,
        })
        del c, o, got, plain
    return rows


# phase 25: the flat pair list's fill (csrc/flat_pairs.cu)
FILL_G = 1000  # the empty gene of the fill cases: padding slots hold it
# a heavy chunk as the first chunk of a job (the largest pair_cap) holds
# it in the benchmark's cells: rows, cap K, pairs, pair_cap (the fill's
# inputs that one job of each cell gave on the card)
FILL_CHUNKS = {
    "xanthomonas14_annotated heavy chunk": (2560, 23168, 31_564_275,
                                            1 << 25),
    "escherichia30 heavy chunk": (256, 141_312, 36_167_168, 1 << 26),
}


def cummax_pairs(grow, cand, counts, pair_cap, G):
    """(pi, pj) of ``Runner.flatten_join``'s fill as it was written before
    the fill kernel, the oracle of the kernel and of its plain twin:
    every row with candidates marks its id at its exclusive base, a
    running maximum (``torch.cummax``) spreads it over the row's slots."""
    import torch

    dev = grow.device
    K = cand.shape[-1]
    gf = grow.reshape(-1)
    cf = cand.reshape(-1, K)
    nf = counts.reshape(-1)
    nf = torch.where(nf > K, torch.zeros_like(nf), nf)
    cs = torch.cumsum(nf, 0, dtype=torch.int64)
    total = cs[-1]
    p = torch.arange(pair_cap, dtype=torch.int64, device=dev)
    b = cs - nf
    row_ids = torch.arange(gf.shape[0], dtype=torch.int64, device=dev)
    sel = (nf > 0) & (b < pair_cap)
    marks = torch.zeros(pair_cap, dtype=torch.int64, device=dev)
    marks.scatter_reduce_(0, b[sel], row_ids[sel], "amax")
    r = torch.cummax(marks, 0).values
    r_safe = torch.clamp(r, max=gf.shape[0] - 1)
    base = torch.where(r_safe > 0, cs[torch.clamp(r_safe - 1, min=0)],
                       torch.zeros_like(r_safe))
    s = torch.clamp(p - base, 0, K - 1)
    ok = p < total
    pad = torch.full((pair_cap,), G, dtype=torch.int32, device=dev)
    return (torch.where(ok, gf[r_safe].to(torch.int32), pad),
            torch.where(ok, cf[r_safe, s].to(torch.int32), pad))


def fill_extraction(lead, R, K, counts, seed=0):
    """(grow, cand, counts) on the CPU, of shape lead + [R] (+ [K]):
    distinct row genes below FILL_G where they fit, random candidates,
    the given counts."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = int(np.prod(lead, dtype=np.int64)) * R
    grow = (rng.permutation(FILL_G)[:n] if n <= FILL_G
            else rng.integers(0, FILL_G, n))
    cand = rng.integers(0, FILL_G, (n, K))
    counts = np.broadcast_to(np.asarray(counts, np.int64), (n,))
    return (torch.from_numpy(grow.astype(np.int32)).reshape(*lead, R),
            torch.from_numpy(cand.astype(np.int32)).reshape(*lead, R, K),
            torch.from_numpy(counts.astype(np.int32)).reshape(*lead, R))


def _fill_random(lead, R, K, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    # a fifth of the rows empty, a tenth past the cap
    counts = rng.integers(1, K + 1, int(np.prod(lead)) * R)
    counts[rng.random(counts.size) < 0.2] = 0
    counts[rng.random(counts.size) < 0.1] = K + 1 + rng.integers(0, 5)
    return fill_extraction(lead, R, K, counts, seed)


# the fill's edge cases, small enough for the CPU: name -> a function
# that makes (grow, cand, counts)
FILL_CASES = {
    # leading block x ring-step axes, as the ring's extraction gives them
    "blocks": lambda: _fill_random((6,), 16, 8, 1),
    "blocks_x_steps": lambda: _fill_random((4, 3), 16, 8, 2),
    "wide_rows": lambda: _fill_random((2,), 8, 300, 3),
    "no_pairs": lambda: fill_extraction((3,), 8, 4, 0),
    "every_row_past_the_cap": lambda: fill_extraction((2,), 8, 4, 5),
    "every_row_exactly_K": lambda: fill_extraction((2,), 8, 4, 4),
    "one_row": lambda: fill_extraction((1,), 1, 128, 77),
    "one_row_wider_than_many_tiles": lambda: fill_extraction(
        (1,), 1, 9000, 9000),
    "leading_and_trailing_empty_rows": lambda: fill_extraction(
        (1,), 9, 5, [0, 0, 0, 3, 0, 5, 0, 0, 0]),
    "empty_runs_between_rows": lambda: fill_extraction(
        (1,), 6000, 3, [3 if i % 1500 == 7 else 0 for i in range(6000)]),
}


def fill_tile_cases():
    """Extractions whose rows meet the kernel's 2048-slot tiles in every
    way, for the card: rows that straddle a tile boundary, a row wider
    than several tiles, more rows in a tile than it stages, many short
    rows under leading axes."""
    import numpy as np

    rng = np.random.default_rng(11)
    return {
        # no row ends on a tile edge
        "rows_straddle_tiles": lambda: fill_extraction(
            (4,), 16, 1100, rng.integers(1000, 1100, 64)),
        "row_wider_than_tiles": lambda: fill_extraction(
            (1,), 3, 9000, [100, 9000, 2500]),
        # more owners in a tile than it stages: runs of empty rows
        "more_rows_than_staged": lambda: fill_extraction(
            (1,), 40000, 2048,
            np.where(np.arange(40000) % 9000 == 5, 2047, 0)),
        "many_short_rows": lambda: fill_extraction(
            (2, 3), 1000, 4, rng.integers(0, 3, 6000)),
    }


FILL_SLACKS = ("exact", "padded", "cut")


def fill_pair_cap(grow, cand, counts, slack):
    """The pair_cap of a fill case: its pairs ``exact``ly, ``padded`` to
    a power of two and a tile more, or ``cut`` to half of them."""
    import torch

    nf = counts.reshape(-1).long()
    total = int(torch.where(nf > cand.shape[-1], 0, nf).sum())
    return {"exact": max(1, total),
            "padded": (1 << max(7, (total - 1).bit_length())) + 2048,
            "cut": max(1, total // 2)}[slack]


def heavy_chunk(dev, R, K, total, seed):
    """A heavy chunk's extraction on the card: R rows at cap K holding
    ``total`` pairs (each row K less a share of the shortfall, drawn)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    short = rng.multinomial(R * K - total, np.full(R, 1.0 / R))
    counts = torch.from_numpy((K - short).astype(np.int32)).to(dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    G = 1 << 18
    grow = torch.randperm(G, generator=g, device=dev)[:R].to(torch.int32)
    cand = torch.randint(0, G, (R, K), generator=g, device=dev,
                         dtype=torch.int32)
    return grow, cand, counts, G


def fill_row(label, args, pair_cap, G):
    """The fill kernel at one shape: bit-equal to its plain twin and to
    the cummax form on the card, then the wrapper's mean ms (CUDA
    events; the row bounds' prefix sum and the kernel), the twin's and
    the cummax form's, and the least time of the bytes (8 written a
    slot, a candidate read a pair, a row's id and bound read once, at
    HBM rate).  Returns the ``kernels`` entry."""
    import torch

    from pandelos_tpu_torch.ops import flat_pairs as fp

    rows = fp._rows(*args)
    R, K = rows[1].shape
    total = int(rows[2][-1]) if R else 0
    got = fp.flat_pairs(*args, pair_cap, G)
    torch.cuda.synchronize()  # a fault in the kernel shows here
    for other, what in ((fp.flat_pairs_plain(*rows, pair_cap, G), "plain"),
                        (cummax_pairs(*args, pair_cap, G), "cummax")):
        for a, b in zip(got, other):
            if not torch.equal(a, b):
                raise AssertionError(f"flat_pairs != {what} at {label}")
    # the slower forms first: the kernel's reps then find the card's
    # clocks up
    plain_ms = cuda_ms(lambda: fp.flat_pairs_plain(*rows, pair_cap, G), 3)
    cummax_ms = cuda_ms(lambda: cummax_pairs(*args, pair_cap, G), 3)
    ms = cuda_ms(lambda: fp.flat_pairs(*args, pair_cap, G), reps=50)
    nbytes = 8 * pair_cap + 4 * min(total, pair_cap) + 12 * R
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(25, f"flat_pairs {label} (R {R}, K {K}, pairs {total}, pair_cap "
        f"{pair_cap}): bit-equal to plain and to the cummax form; kernel "
        f"{ms:.4f} ms, bound {bound_ms:.4f} ms (bytes; "
        f"{100 * bound_ms / ms:.2f} %), plain {plain_ms:.4f} ms, cummax "
        f"{cummax_ms:.4f} ms")
    return {
        "name": "flat_pairs", "shape": label, "route": "cuda",
        "source": "pandelos_tpu_torch/csrc/flat_pairs.cu",
        "replaces": "none (pandelos_tpu/ops/candidate.py "
                    "_flatten_join_program fills with XLA ops)",
        "launches": None, "max_abs_err": 0, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        # the library ops it replaced: scatter-max, torch.cummax, gathers
        "library_ms": cummax_ms,
    }


def fill_phase(dev):
    """Phase 25, before the paths: the fill kernel on the card against
    its plain twin and the cummax form, bit for bit, on FILL_CASES and
    the tile cases at three pair_caps each (after a synchronize), then
    :func:`fill_row` at the heavy chunks of FILL_CHUNKS.  The main list's
    row follows phase 6, on the inputs that run gave the kernel."""
    import torch

    from pandelos_tpu_torch.ops import flat_pairs as fp

    cases = {**FILL_CASES, **fill_tile_cases()}
    n = 0
    for name, make in cases.items():
        args = [t.to(dev) for t in make()]
        for slack in FILL_SLACKS:
            pair_cap = fill_pair_cap(*args, slack)
            got = fp.flat_pairs(*args, pair_cap, FILL_G)
            torch.cuda.synchronize()
            want = cummax_pairs(*args, pair_cap, FILL_G)
            plain = fp.flat_pairs_plain(*fp._rows(*args), pair_cap, FILL_G)
            for g, w, p in zip(got, want, plain):
                if not (torch.equal(g, w) and torch.equal(g, p)):
                    raise AssertionError(
                        f"flat_pairs != plain or cummax at {name} {slack}")
            n += 1
    log(25, f"flat_pairs: {n} edge and tile cases ({len(cases)} x "
        f"{FILL_SLACKS}), each bit-equal to plain and to the cummax form "
        f"after a synchronize")
    rows = []
    for seed, (label, (R, K, total, pair_cap)) in enumerate(
            FILL_CHUNKS.items()):
        grow, cand, counts, G = heavy_chunk(dev, R, K, total, 25 + seed)
        rows.append(fill_row(label, (grow, cand, counts), pair_cap, G))
        del grow, cand, counts
    torch.cuda.empty_cache()
    return rows


def check_fills(name, res, joins):
    """Each flat pair list a run joins is filled by the fill kernel
    first: its launches since :func:`zero_launches` must equal the join
    kernels' (``joins``) and the sum of the spans' ``fill_launches``."""
    from pandelos_tpu_torch.ops.flat_pairs import flat_pairs

    n = flat_pairs.launches
    spans = sum(s["counters"].get("fill_launches", 0) for s in res.spans)
    if n != sum(joins.values()) or spans != n:
        raise AssertionError(f"{name}: fill kernel launches {n}, spans' "
                             f"fill_launches {spans}, join launches {joins}")
    return n


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from pandelos_tpu_torch import kernels
    from pandelos_tpu_torch.native import loader
    from pandelos_tpu_torch.ops import kmer_index as ki
    from pandelos_tpu_torch.ops import lane_join
    from pandelos_tpu_torch.ops.candidate import _bf16_round_up
    from pandelos_tpu_torch.ops.hist import host_histogram

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(1, f"device {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; count {torch.cuda.device_count()}")

    # 2. kernel build (one nvcc per source, all started together), then
    # the native host core (g++), so that the phase times below hold no
    # first-use build
    t = time.monotonic()
    times = kernels.build_all()
    log(2, f"kernels built in {time.monotonic() - t:.2f}s: {times}")
    t = time.monotonic()
    if not loader.native_available():
        raise RuntimeError("native host core unavailable (PANDELOS_NATIVE=0?)")
    log(2, f"native host core ready in {time.monotonic() - t:.2f}s")
    for name, rec in kernels.BUILD_LOG.items():
        for line in rec["nvcc"].splitlines():
            if "registers" in line or "spill" in line:
                log(2, f"{name}: {line.strip()}")

    # 3. each join kernel vs its plain version on seeded random tables
    for seed, jk in enumerate(JOINS):
        args = random_join_inputs(jk, dev, seed)
        r = check_join(jk, "random", args,
                       plain_chunk=1 << 14 if jk == "roll" else 1 << 16)
        log(3, f"{jk} random tables (table {tuple(args[0].shape)}, P "
            f"{args[-1].shape[0]}): bit-equal; kernel {r[2]:.4f} ms, plain "
            f"{r[1]:.1f} ms, bound {r[3]:.4f} ms ({r[4]}), per-pair row "
            f"traffic {r[5]:.4f} ms")
        del args
    for seed, jk in enumerate(JOINS):
        kernel, plain = join_fns(jk)
        n_lists = n_pairs = 0
        for label, args in adversarial_join_cases(jk, dev, 20 + seed):
            got = kernel(*args)
            torch.cuda.synchronize()  # a fault in the kernel shows here
            for g, w in zip(got, plain(*args)):
                if not torch.equal(g, w):
                    raise AssertionError(
                        f"{jk} kernel != plain on adversarial list: {label}")
            n_lists += 1
            n_pairs += args[-1].shape[0]
        log(3, f"{jk} adversarial tables: {n_lists} pair lists, {n_pairs} "
            f"pairs, each bit-equal to plain after a synchronize")
    args = deep_join_case(dev, 40)
    got = lane_join.lane_join(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, lane_join.lane_join_plain(*args)):
        if not torch.equal(g, w):
            raise AssertionError("lane kernel != plain on the deep rows")
    log(3, f"lane deep rows (table {tuple(args[0].shape)}, depths "
        f"{sorted(set(args[1].tolist()))}, {args[2].shape[0]} pairs): "
        f"bit-equal to plain after a synchronize")
    del args
    log(3, f"launches in phase 3 (kernel checks, not a path): {launches()}")
    index_rows = index_phase(dev)
    fill_rows = fill_phase(dev)
    if sys.argv[1:] == ["--kernels-only"]:
        return 0

    # 4. division parity: torch f32 division on the card == numpy
    rng = np.random.default_rng(4)
    n = 1 << 24
    u = rng.integers(1, 1 << 24, size=n).astype(np.int64)
    i = rng.integers(1, u + 1)
    # tests/test_exact_div.py's cases: every 1 <= i <= u < 200 (x/x
    # among them) and the near-tie numerators over u = 2^24 - 1
    r, c = np.tril_indices(199)
    ties = np.asarray([0x800000, 0x800001, 0xFFFFFF])
    edge_i = np.concatenate([c + 1, np.minimum(ties, (1 << 24) - 1)])
    edge_u = np.concatenate([r + 1, np.full(3, (1 << 24) - 1)])
    i = np.concatenate([i, edge_i]).astype(np.int32)
    u = np.concatenate([u, edge_u]).astype(np.int32)
    from pandelos_tpu_torch.ops.exact_div import exact_div_f32

    got = exact_div_f32(torch.from_numpy(i).to(dev), torch.from_numpy(u).to(dev))
    want = i.astype(np.float32) / u.astype(np.float32)
    bad = int((got.cpu().numpy().view(np.int32) != want.view(np.int32)).sum())
    if bad:
        raise AssertionError(f"division: {bad} quotients differ from numpy")
    log(4, f"division parity: {len(i)} quotients bit-equal to numpy "
        f"({n} random 1<=i<=u<2^24 + {len(edge_i)} edge cases)")

    outdir = tempfile.mkdtemp(prefix="pandelos_smoke_")
    entries = {}
    try:
        # 6. the main path end to end (counters zeroed just before it)
        cap = {}
        torch.cuda.empty_cache()
        held6 = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_launches()
        ki.kmer_index.launches = 0
        for k in loader.CALLS:
            loader.CALLS[k] = 0
        res, wall, _ = run(MAIN, outdir, capture=cap)
        n6 = launches()
        n6_fill = check_fills(MAIN, res, n6)
        n6_index = ki.kmer_index.launches
        peak6 = torch.cuda.max_memory_allocated(dev)
        native = dict(loader.CALLS)
        net = res.stats["network"]
        if n6["lane2"] < 1 or n6["lane"] or n6["roll"]:
            raise AssertionError(f"main path launches {n6}: lane2 only")
        if native["gn_families"] < 1:
            raise AssertionError(f"native clustering unused: {native}")
        on_card = [s["counters"].get("on_card") for s in res.spans
                   if s["name"] == "index"]
        if on_card != [1]:
            raise AssertionError(f"main path index not built on the card: "
                                 f"on_card {on_card}")
        per_build = [r["launches_per_build"] for r in index_rows
                     if r["shape"] == MAIN]
        if [n6_index] != per_build:
            raise AssertionError(f"main path index launches {n6_index}: "
                                 f"not one build ({per_build} in phase 24)")
        for r in index_rows:
            r["launches"] = n6_index
        fill_span = [s["counters"].get("fill_launches") for s in res.spans
                     if s["name"] == "flatten_join"]
        if n6_fill != 1 or fill_span != [1]:
            raise AssertionError(f"main path fill launches {n6_fill}, "
                                 f"flatten_join's {fill_span}: want 1")
        got6 = check_targets(MAIN, res)
        log(6, f"{MAIN} .net/.clus byte-identical to golden; n_cells "
            f"{got6['n_cells']} / {MAIN_TARGETS['n_cells']}, edges "
            f"{got6['edges']} / {MAIN_TARGETS['edges']}, families "
            f"{got6['families']} / {MAIN_TARGETS['families']}; launches "
            f"{n6}, kmer_index {n6_index}, flat_pairs {n6_fill}; native "
            f"calls {native}; wall {wall:.2f}s")
        log(6, "phase_times " + json.dumps(
            {k: round(v, 4) for k, v in res.phase_times.items()}))
        log(6, "device phases " + json.dumps(net["phase_s"]))
        log(6, f"pair_cap {net['pair_cap']}, joined pairs "
            f"{net['n_joined_pairs']}, K {net['candidate_cap_final']}, "
            f"lane_D {net['lane_D']}, bound bits {net['bound_bits_mode']}, "
            f"peak device memory {peak6 / 1e9:.2f} GB ({held6 / 1e9:.2f} GB "
            f"held before the run)")
        check_memory_model(6, cap["index"], dict(backend="cuda"),
                           net["candidate_cap_final"], peak6 - held6, dev,
                           pair_cap=net["pair_cap"])

        # 5. bound bits and signatures of the main path vs the host
        from scipy import sparse

        runner = cap["runner"]
        if not cap["use_T"]:
            raise AssertionError("main path did not run in bound-bit mode")
        T = runner.bound_bits(cap["perm_ext"], cap["starts"], cap["row_block"])
        n_pos = T.shape[0]
        perm_d = torch.from_numpy(
            np.asarray(cap["perm_ext"][:n_pos], np.int64)).to(dev)
        sig_p = runner.sig[perm_d]  # [n_pos, B] bf16, rows in perm order
        nz = sig_p.nonzero()
        vals = sig_p[nz[:, 0], nz[:, 1]].double().cpu().numpy()
        nz = nz.cpu().numpy()
        S = sparse.csr_matrix((vals, (nz[:, 0], nz[:, 1])), shape=sig_p.shape)
        Pm = S.copy()
        Pm.data[:] = 1.0
        lens = runner.col_lens[perm_d].double().cpu().numpy()
        s0 = max(0, n_pos // 2 - 1024)
        sl = slice(s0, min(n_pos, s0 + 2048))
        k2 = 2 * cap["index"].k
        fwd = (S[sl] @ Pm.T).toarray()  # test1(p, q), p in the slice
        bwd = (S @ Pm[sl].T).toarray().T  # test1(q, p)
        t_ref = (k2 * fwd >= lens[sl, None]) | (k2 * bwd >= lens[None, :])
        t_dev = T[sl].cpu().numpy() > 0
        if not np.array_equal(t_ref, t_dev):
            raise AssertionError(
                f"bound bits: {int((t_ref != t_dev).sum())} of "
                f"{t_ref.size} differ from the float64 host recomputation"
            )
        rows = perm_d[sl]
        ids = runner.all_ids[rows].cpu().numpy()
        cnts = runner.all_counts[rows].cpu().numpy()
        nb = runner.sig.shape[1]
        from pandelos_tpu_torch.ops.hist import pick_buckets

        idx = cap["index"]
        _, shift = pick_buckets(idx.vocab_size, max(1, idx.max_profile_len),
                                idx.k, n_genes=runner.G_pad)
        want_sig = _bf16_round_up(host_histogram(ids, cnts, nb, shift))
        if not np.array_equal(want_sig, sig_p[sl].float().cpu().numpy()):
            raise AssertionError("signatures differ from the host histogram")
        log(5, f"bound bits: rows {sl.start}..{sl.stop} of T [{n_pos}, "
            f"{n_pos}] equal the float64 host recomputation "
            f"({int(t_ref.sum())} set); their signatures [{nb} buckets] "
            f"equal the host histogram")

        # the lane2 kernel at the main path's shapes: parity, time, bound
        entries["lane2"] = (n6["lane2"], check_captured("lane2", cap, MAIN))
        # 25. the fill kernel on the main list's inputs of phase 6
        (grow, cand, counts), pair_cap = cap["fill"]
        fill_rows.insert(0, fill_row(f"{MAIN} main list",
                                     (grow, cand, counts), pair_cap,
                                     runner.G))
        for r in fill_rows:
            r["launches"] = n6_fill
        del grow, cand, counts
        del cap, runner, T, sig_p, S, Pm
        torch.cuda.empty_cache()

        # 8. the cells path with the lane kernel: compute_cells_candidate,
        # BBH on the host
        cap = {}
        zero_launches()
        res, wall, _ = run(MAIN, outdir, capture=cap, tag="_cells",
                           join_kernel="lane", device_bbh=False)
        n8 = launches()
        check_fills(f"{MAIN}_cells", res, n8)
        if n8["lane"] < 1 or n8["lane2"] or n8["roll"]:
            raise AssertionError(f"cells path launches {n8}: lane only")
        got8 = check_targets(MAIN, res)
        log(8, f"{MAIN} cells path (join_kernel lane, device_bbh False): "
            f".net/.clus byte-identical to golden; {got8}; launches {n8}; "
            f"wall {wall:.2f}s; phase_times " + json.dumps(
                {k: round(v, 4) for k, v in res.phase_times.items()}))
        entries["lane"] = (n8["lane"], check_captured("lane", cap, MAIN))
        del cap
        torch.cuda.empty_cache()

        # 9. the roll join with device BBH
        cap = {}
        zero_launches()
        res, wall, _ = run(MAIN, outdir, capture=cap, tag="_roll",
                           join_kernel="roll")
        n9 = launches()
        check_fills(f"{MAIN}_roll", res, n9)
        if n9["roll"] < 1 or n9["lane2"] or n9["lane"]:
            raise AssertionError(f"roll path launches {n9}: pair join only")
        got9 = check_targets(MAIN, res)
        if res.stats["network"]["lane_table_cols"] is not None:
            raise AssertionError("the roll path built a lane2 table")
        log(9, f"{MAIN} join_kernel roll: .net/.clus byte-identical to "
            f"golden; {got9}; launches {n9}; wall {wall:.2f}s; device phases "
            + json.dumps(res.stats["network"]["phase_s"]))
        entries["roll"] = (n9["roll"], check_captured("roll", cap, MAIN))
        del cap
        torch.cuda.empty_cache()

        # 10. lane2's fallback at full size: an input it cannot pack runs
        # through the lane kernel; the roll join gives the same bytes
        from pandelos_tpu_torch.ops.candidate import _host_fallback_rows

        ds, tracts = homopolymer_dataset()
        cap = {}
        zero_launches()
        res, wall, ref = run(MAIN, outdir, capture=cap, tag="_tract",
                             golden=False, dataset=ds, k=6)
        n10 = launches()
        check_fills(f"{MAIN}_tract", res, n10)
        idx = cap["index"]
        if int(idx.profile_counts.max()) < 256:
            raise AssertionError("the derived input packs")
        if res.stats["network"]["join_kernel"] != "lane" or n10["lane"] < 1 \
                or n10["lane2"]:
            raise AssertionError(
                f"fallback run: {res.stats['network']['join_kernel']}, "
                f"launches {n10}")
        # each tract protein's valid cells from the device join equal
        # the host posting walk's
        pi, pj = cap["pi"].cpu().numpy(), cap["pj"].cpu().numpy()
        ctr = [cap[x].cpu().numpy().astype(np.int64)
               for x in ("inter", "perc", "tr")]
        lens = np.asarray(idx.kseq_lengths, np.int64)
        n_tract_cells = 0
        for r in tracts:
            fb = _host_fallback_rows(idx, [r])
            ok = (2 * idx.k * fb.perc_cnt >= lens[fb.row]) | (
                2 * idx.k * fb.tr_perc_cnt >= lens[fb.col])
            want = {(int(c), int(i), int(p), int(t)) for c, i, p, t in zip(
                fb.col[ok], fb.intersection[ok], fb.perc_cnt[ok],
                fb.tr_perc_cnt[ok])}
            m = (pi == r) & (ctr[0] > 0) & (
                (2 * idx.k * ctr[1] >= lens[r]) | (
                    2 * idx.k * ctr[2] >= lens[np.minimum(pj, len(lens) - 1)]))
            got = {(int(c), int(i), int(p), int(t)) for c, i, p, t in zip(
                pj[m], ctr[0][m], ctr[1][m], ctr[2][m])}
            if got != want:
                raise AssertionError(f"tract protein {r}: device cells "
                                     f"differ from the host posting walk")
            n_tract_cells += len(got)
        del cap
        torch.cuda.empty_cache()
        zero_launches()
        res2, wall2, _ = run(MAIN, outdir, tag="_tract_roll", golden=ref,
                             dataset=ds, k=6, join_kernel="roll")
        n10r = launches()
        check_fills(f"{MAIN}_tract_roll", res2, n10r)
        if n10r["roll"] < 1:
            raise AssertionError(f"fallback roll run launches {n10r}")
        log(10, f"{MAIN} + poly-Q/N tracts on proteins {tracts} (max 6-mer "
            f"count {int(idx.profile_counts.max())}): default config ran "
            f"join_kernel lane (launches {n10}), roll (launches {n10r}); "
            f".net/.clus byte-identical between them; edges "
            f"{len(res.edges)}, families {res.stats['n_families']}; the "
            f"tract proteins' {n_tract_cells} valid cells equal the host "
            f"posting walk; walls {wall:.2f}s, {wall2:.2f}s")
        del idx, res2
        torch.cuda.empty_cache()

        # 11-13. the JAX package's kernel-free backends: the xla backend
        # with device BBH (what a plain JAX `run` takes), its cells path,
        # and the dense backend; none may launch a join kernel
        for ph, tag, cfg in ((11, "_xla", dict(backend="xla")),
                             (12, "_xla_cells", dict(backend="xla",
                                                     device_bbh=False)),
                             (13, "_dense", dict(backend="dense"))):
            cap = {}
            # the earlier runs' device memory went with their last
            # reference (no collection: an index and its runner do not
            # hold each other)
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated(dev)
            log(ph, f"held before the run {held / 1e9:.4f} GB, before "
                f"phase 6 {held6 / 1e9:.4f} GB")
            if abs(held - held6) > HELD_SLACK_BYTES:
                raise AssertionError(
                    f"phase {ph}: {held} bytes held before the run, "
                    f"{held6} before phase 6")
            torch.cuda.reset_peak_memory_stats(dev)
            zero_launches()
            res, wall, _ = run(MAIN, outdir, capture=cap, tag=tag, **cfg)
            n = launches()
            if any(n.values()):
                raise AssertionError(f"{tag}: join kernels launched {n}")
            check_fills(tag, res, n)
            got = check_targets(MAIN, res)
            net = res.stats["network"]
            peak = torch.cuda.max_memory_allocated(dev)
            log(ph, f"{MAIN} {cfg}: .net/.clus byte-identical to golden; "
                f"{got}; launches {n}; wall {wall:.2f}s; peak device memory "
                f"{peak / 1e9:.2f} GB ({held / 1e9:.2f} GB held before the "
                f"run)")
            log(ph, "phase_times " + json.dumps(
                {k: round(v, 4) for k, v in res.phase_times.items()}))
            if "phase_s" in net:
                log(ph, "device phases " + json.dumps(net["phase_s"])
                    + f"; K {net['candidate_cap_final']}, joined pairs "
                    f"{net['n_joined_pairs']}")
                check_memory_model(ph, cap["runner"].index, cfg,
                                   net["candidate_cap_final"], peak - held,
                                   dev)
            spans = {s["name"]: s for s in res.spans}
            if "score.dense_pass" in spans:
                secs = {n: (spans[n]["end_ns"] - spans[n]["start_ns"]) / 1e9
                        for n in ("score.dense_pass",
                                  "score.host_corrections")}
                log(ph, f"dense pass span {secs['score.dense_pass']:.4f}s "
                    f"(padding, upload, matmuls, compaction, fetch; "
                    f"{cap['dense_matmul_flops']:.4e} matmul flop), host "
                    f"corrections span "
                    f"{secs['score.host_corrections']:.4f}s")
            del cap, res
            torch.cuda.empty_cache()

        # 14. profiled runs (config.profile_dir, torch.profiler) of the
        # default path, xla and dense: the card's busy share of the whole
        # job, and the kernels that fill it
        for tag, cfg in (("_prof_cuda", {}),
                         ("_prof_xla", dict(backend="xla")),
                         ("_prof_dense", dict(backend="dense"))):
            pdir = os.path.join(outdir, "profile" + tag)
            res, wall, _ = run(MAIN, outdir, tag=tag, profile_dir=pdir, **cfg)
            check_targets(MAIN, res)
            with open(os.path.join(pdir, "profile_summary.json")) as fh:
                summ = json.load(fh)
            share = summ["busy_share"]
            if share is None or not 0 < share <= 1:
                raise AssertionError(f"{tag}: busy_share {share}")
            matmul_s = sum(k["seconds"] for k in summ["top_kernels"]
                           if MATMUL_KERNEL.search(k["name"]))
            log(14, f"{MAIN} {cfg or dict(backend='cuda')} profiled: "
                f".net/.clus byte-identical to golden; wall {wall:.2f}s; "
                f"window {summ['window_s']:.4f}s (the whole job; score "
                f"{res.phase_times['score']:.4f}s), device busy "
                f"{summ['device_busy_s']:.4f}s, busy_share {share:.4f}, "
                f"{summ['n_kernel_launches']} kernel launches; matmul "
                f"kernels (top ten) {matmul_s:.4f}s")
            log(14, "top kernels [name, launches, s] " + json.dumps(
                [[k["name"][:90], k["launches"], round(k["seconds"], 6)]
                 for k in summ["top_kernels"]]))
            del res
            shutil.rmtree(pdir)  # the traces run to tens of MB

        # 7. a smaller preset (the example presets follow in 15)
        for name in PRESETS:
            r, w, _ = run(name, outdir)
            log(7, f"{name}: .net/.clus byte-identical to golden; edges "
                f"{len(r.edges)}, families {r.stats['n_families']}; wall "
                f"{w:.2f}s")

        # 15. the CLI's examples command (the reference's example runner:
        # generate each preset, run it, report its quality) over its four
        # presets, in a process of its own on the card
        wd = os.path.join(outdir, "examples")
        torch.cuda.empty_cache()
        t = time.monotonic()
        proc = subprocess.run(
            [sys.executable, "-m", "pandelos_tpu_torch.cli", "examples", wd],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise AssertionError(f"cli examples exited {proc.returncode}: "
                                 f"{proc.stderr[-3000:]}")
        with open(os.path.join(wd, "examples.json")) as fh:
            summary = json.load(fh)
        for name in EXAMPLES:
            for suffix in (".faa", ".net", ".clus"):
                if not filecmp.cmp(os.path.join(wd, name + suffix),
                                   os.path.join(CACHE, name + suffix),
                                   shallow=False):
                    raise AssertionError(f"cli examples: {name}{suffix} "
                                         f"differs from bench_cache")
            log(15, f"cli examples {name}: generated .faa and .net/.clus "
                f"byte-identical to bench_cache; families "
                f"{summary[name]['n_families']}, core families "
                f"{summary[name]['quality']['core_families']}; run "
                f"{summary[name]['elapsed_s']}s")
        log(15, f"cli examples: {len(EXAMPLES)} presets in "
            f"{time.monotonic() - t:.2f}s (process start, preset "
            f"generation and runs)")

        # 16. the reference backend: the whole-run transcription twin, on
        # the host
        from pandelos_tpu_torch.config import PipelineConfig
        from pandelos_tpu_torch.pipeline import run_pipeline

        gold = os.path.join(ROOT, "tests", "golden", "synth_real")
        prefix = os.path.join(outdir, "synth_real_reference")
        t = time.monotonic()
        res = run_pipeline(gold + ".faa", prefix,
                           PipelineConfig(backend="reference"))
        for suffix in (".net", ".clus"):
            if not filecmp.cmp(prefix + suffix, gold + suffix, shallow=False):
                raise AssertionError(f"reference backend: synth_real{suffix} "
                                     f"differs from tests/golden")
        log(16, f"reference backend on synth_real ({res.n_sequences} genes): "
            f".net/.clus byte-identical to tests/golden; edges "
            f"{len(res.edges)}, families {res.stats['n_families']}; wall "
            f"{time.monotonic() - t:.2f}s")
        # 17-20, 22. four shards on the one card (the devices= placement,
        # the counterpart of JAX's virtual devices): the replicated engine,
        # the ring with device BBH, the ring's cells path with the lane
        # kernel, xla, and the roll join; each shard runs its own rows and
        # the collectives merge them
        sharded_phases(dev, outdir)

        # 21. --distributed in a process of its own: an NCCL group of one
        distributed_phase(outdir)

        # 23. the option combinations that the JAX package runs otherwise
        # than asked, run as it runs them
        combination_phase(dev, outdir)
    finally:
        shutil.rmtree(outdir, ignore_errors=True)

    out = []
    for jk, (n, r) in entries.items():
        wrapper, _, _, src, replaces = JOINS[jk]
        out.append({
            "name": wrapper,
            "route": "cuda",
            "source": f"pandelos_tpu_torch/csrc/{src}",
            "replaces": replaces,
            "launches": n,
            "max_abs_err": r[0],
            "ms": r[2],
            "plain_ms": r[1],
            "bound_ms": r[3],
            "bound_by": r[4],
            "library_ms": None,
        })
    out.extend(index_rows)
    out.extend(fill_rows)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
