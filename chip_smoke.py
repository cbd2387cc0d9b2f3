"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``pandelos_tpu_torch/csrc`` (lane2,
lane and pair joins), holds each against its plain PyTorch version on
the card on seeded random tables and at the shapes of the runs below,
checks the device division and the bound bits against the host, and
drives the engine (``.faa`` -> ``.net`` + ``.clus``, backend ``"cuda"``)
on ``bench_cache/mycoplasma64.faa`` at full size through each of its
paths: the default (lane2, device BBH), the cells path with the lane
kernel (host BBH), the roll join, and lane2's fallback on an input that
cannot pack (derived from mycoplasma64 with four seeded homopolymer
tracts); then the four smaller presets.  Every output must be
byte-identical to its committed golden (the derived input's two runs to
each other).  Phases print one line each; a ``kernels`` JSON line comes
before the last line, and the last line is the result object.  Any
failure exits non-zero without a result; so does a machine without a
card, and a directory without the package.
"""

from __future__ import annotations

import filecmp
import json
import os
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
PRESETS = ["salmonella7", "escherichia10", "xanthomonas14", "mycoplasma16"]
# H100 SXM published peaks (NVIDIA data sheet, 700 W); the guide's table
# has no int32 row, so int32 compare-and-add work is held to the CUDA
# cores' f32 rate (the same cores issue int32 ops)
HBM_BYTES_PER_S = 3.35e12
CORE_OPS_PER_S = 67e12


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
    for k in JOINS:
        join_fns(k)[0].launches = 0


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


def check_captured(kind, cap, name):
    """The kernel at the shapes a run gave it: its rerun equals the run's
    counters, and check_join on the run's inputs."""
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
    log(3, f"{kind} at {name} shapes (table {tuple(args[0].shape)}, P "
        f"{args[-1].shape[0]}): bit-equal to plain; kernel {r[2]:.4f} ms, "
        f"plain {r[1]:.1f} ms, bound {r[3]:.4f} ms ({r[4]}), per-pair row "
        f"traffic {r[5]:.4f} ms")
    return r


def run(name, outdir, capture=None, golden=None, tag="", dataset=None,
        **config):
    """One run_pipeline with backend "cuda" on the card; its .net and
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
        PipelineConfig(backend="cuda", device="cuda", **config),
        dataset=dataset, capture=capture,
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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    from pandelos_tpu_torch import kernels
    from pandelos_tpu_torch.native import loader
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
    log(3, f"launches in phase 3 (kernel checks, not a path): {launches()}")

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
        zero_launches()
        for k in loader.CALLS:
            loader.CALLS[k] = 0
        res, wall, _ = run(MAIN, outdir, capture=cap)
        n6 = launches()
        native = dict(loader.CALLS)
        net = res.stats["network"]
        if n6["lane2"] < 1 or n6["lane"] or n6["roll"]:
            raise AssertionError(f"main path launches {n6}: lane2 only")
        if native["build_index"] < 1 or native["gn_split"] < 1:
            raise AssertionError(f"native cores unused: {native}")
        got6 = check_targets(MAIN, res)
        log(6, f"{MAIN} .net/.clus byte-identical to golden; n_cells "
            f"{got6['n_cells']} / {MAIN_TARGETS['n_cells']}, edges "
            f"{got6['edges']} / {MAIN_TARGETS['edges']}, families "
            f"{got6['families']} / {MAIN_TARGETS['families']}; launches "
            f"{n6}; native calls {native}; wall {wall:.2f}s")
        log(6, "phase_times " + json.dumps(
            {k: round(v, 4) for k, v in res.phase_times.items()}))
        log(6, "device phases " + json.dumps(net["phase_s"]))
        log(6, f"pair_cap {net['pair_cap']}, joined pairs "
            f"{net['n_joined_pairs']}, K {net['candidate_cap_final']}, "
            f"lane_D {net['lane_D']}, bound bits {net['bound_bits_mode']}, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")

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
        del cap, runner, T, sig_p, S, Pm
        torch.cuda.empty_cache()

        # 8. the cells path with the lane kernel: compute_cells_candidate,
        # BBH on the host
        cap = {}
        zero_launches()
        res, wall, _ = run(MAIN, outdir, capture=cap, tag="_cells",
                           join_kernel="lane", device_bbh=False)
        n8 = launches()
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

        # 7. the four smaller presets
        for name in PRESETS:
            r, w, _ = run(name, outdir)
            log(7, f"{name}: .net/.clus byte-identical to golden; edges "
                f"{len(r.edges)}, families {r.stats['n_families']}; wall "
                f"{w:.2f}s")
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
