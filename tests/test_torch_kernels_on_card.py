"""The port's CUDA kernels on the card: each join kernel against its plain
PyTorch version bit for bit, no fallback when a kernel cannot load, and
the engine's paths to the goldens through the kernels.  Every test needs
an NVIDIA card and skips without one.  The file imports neither JAX nor
the JAX package, so it also runs where JAX is absent:

    python3 -m pytest --noconftest -o markers=cuda -p no:cacheprovider -q \\
        tests/test_torch_kernels_on_card.py
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from pandelos_tpu_torch import kernels
from pandelos_tpu_torch.config import PipelineConfig
from pandelos_tpu_torch.ops import lane_join as tlj
from pandelos_tpu_torch.ops import pair_join as tpj
from pandelos_tpu_torch.pipeline import run_pipeline

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture
def card():
    """The card, or a skip where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def _profiles(seed, n_genes, vocab, max_count, id_base, G_pad, W):
    """Seeded padded profiles (pad_profiles layout) and their lane
    depths: empty rows among them, padding genes past ``n_genes``."""
    rng = np.random.default_rng(seed)
    ids = np.full((G_pad, W), id_base + vocab, np.int32)
    cnt = np.zeros((G_pad, W), np.int32)
    dg = np.zeros(G_pad, np.int32)
    for g in range(n_genes):
        w = int(rng.integers(0, min(W, vocab) + 1))
        v = id_base + np.sort(rng.choice(vocab, size=w, replace=False))
        ids[g, :w] = v
        cnt[g, :w] = rng.integers(1, max_count, size=w)
        if w:
            dg[g] = np.bincount(v & 127, minlength=128).max()
    a = rng.integers(0, G_pad, size=5000).astype(np.int32)
    b = rng.integers(0, G_pad, size=5000).astype(np.int32)
    b[:100] = a[:100]
    return ids, cnt, dg, a, b


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lane2", "lane", "roll"])
def test_kernel_matches_plain_on_card(card, kind):
    wide = kind != "lane2"  # counts to 999 and ids past 2^23
    ids, cnt, dg, a, b = _profiles(
        5, 40, 3000, 1000 if wide else 256, (1 << 23) + 1 if wide else 0,
        48, 2048)
    ids_d, cnt_d = torch.from_numpy(ids).to(card), torch.from_numpy(cnt).to(
        card)
    pairs = (torch.from_numpy(a).to(card), torch.from_numpy(b).to(card))
    if kind == "roll":
        fn, plain = tpj.join_pairs_core, tpj.join_pairs_plain
        args = (tpj.pack_profiles(ids_d, cnt_d),) + pairs
    else:
        fn, plain = ((tlj.lane2_join, tlj.lane2_join_plain) if kind == "lane2"
                     else (tlj.lane_join, tlj.lane_join_plain))
        table = tlj.pack_lane_device_core(ids_d, cnt_d, int(dg.max()),
                                          packed=not wide)
        args = (table, torch.from_numpy(dg).to(card)) + pairs
    launches = fn.launches
    got = fn(*args)
    torch.cuda.synchronize()
    assert fn.launches == launches + 1
    for g, w in zip(got, plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_card_calls_raise_when_a_kernel_cannot_load(card, monkeypatch):
    """No fallback to the plain version on the card: a kernel that does
    not build or load makes the call raise."""
    def broken(name):
        raise RuntimeError(f"cannot load {name}")

    monkeypatch.setattr(kernels, "load", broken)
    z = torch.zeros(8, dtype=torch.int32, device=card)
    dg = torch.zeros(4, dtype=torch.int32, device=card)
    table = torch.zeros((4, 256), dtype=torch.int32, device=card)
    with pytest.raises(RuntimeError, match="cannot load lane2_join"):
        tlj.lane2_join(table, dg, z, z)
    with pytest.raises(RuntimeError, match="cannot load lane_join"):
        tlj.lane_join(table, dg, z, z)
    with pytest.raises(RuntimeError, match="cannot load pair_join"):
        tpj.join_pairs_core(table, z, z)
    with pytest.raises(RuntimeError, match="cannot load pair_join"):
        tpj.join_pairs(table, np.zeros(3, np.int64), np.ones(3, np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("join_kernel", ["lane2", "lane", "roll"])
@pytest.mark.parametrize("device_bbh", [None, False])
def test_engine_paths_reproduce_golden_on_card(card, tmp_path, join_kernel,
                                               device_bbh):
    fn = {"lane2": tlj.lane2_join, "lane": tlj.lane_join,
          "roll": tpj.join_pairs_core}[join_kernel]
    launches = fn.launches
    prefix = str(tmp_path / "synth_small")
    run_pipeline(os.path.join(GOLDEN, "synth_small.faa"), prefix,
                 PipelineConfig(row_block=16, col_block=128, candidate_cap=64,
                                join_kernel=join_kernel,
                                device_bbh=device_bbh))
    assert fn.launches > launches
    for suffix in (".net", ".clus"):
        assert filecmp.cmp(prefix + suffix,
                           os.path.join(GOLDEN, "synth_small" + suffix),
                           shallow=False), suffix
