"""The flat pair list's fill (``ops/flat_pairs.py``) on the CPU: its plain
twin, which the CPU runs and the card's kernel (``csrc/flat_pairs.cu``)
is held to in ``test_torch_kernels_on_card.py`` and ``chip_smoke.py``,
against the formulation it replaced (a scatter-max of each row's id at
its base and a running maximum, ``chip_smoke.cummax_pairs``), bit for
bit, on random and edge-case counts (``chip_smoke.FILL_CASES``).  The
file imports neither JAX nor the JAX package."""

import pytest
import torch

from chip_smoke import (
    FILL_CASES,
    FILL_G,
    FILL_SLACKS,
    cummax_pairs,
    fill_extraction,
    fill_pair_cap,
)
from pandelos_tpu_torch.ops import flat_pairs as fp


@pytest.mark.parametrize("slack", FILL_SLACKS)
@pytest.mark.parametrize("name", sorted(FILL_CASES))
def test_plain_fill_matches_the_cummax_formulation(name, slack):
    grow, cand, counts = FILL_CASES[name]()
    pair_cap = fill_pair_cap(grow, cand, counts, slack)
    launches, launched = fp.flat_pairs.launches, []
    got = fp.flat_pairs(grow, cand, counts, pair_cap, FILL_G, launched)
    want = cummax_pairs(grow, cand, counts, pair_cap, FILL_G)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and g.shape == (pair_cap,)
        assert torch.equal(g, w)
    # no kernel on the CPU
    assert fp.flat_pairs.launches == launches and launched == []


def test_plain_fill_lays_rows_end_to_end():
    """Slot by slot: each row's first counts[r] candidates in row order,
    rows past the cap and empty rows skipped, then the padding."""
    grow, cand, counts = fill_extraction((1,), 4, 3, [2, 0, 4, 3])
    pi, pj = fp.flat_pairs(grow, cand, counts, 8, FILL_G)
    g, c = grow.reshape(-1), cand.reshape(-1, 3)
    G = FILL_G
    assert pi.tolist() == [g[0], g[0], g[3], g[3], g[3], G, G, G]
    assert pj.tolist() == [c[0, 0], c[0, 1], c[3, 0], c[3, 1], c[3, 2],
                           G, G, G]


def test_fill_refuses_inputs_it_cannot_take():
    grow, cand, counts = fill_extraction((1,), 4, 3, 2)
    with pytest.raises(ValueError, match="K 0"):
        fp.flat_pairs(grow, cand[..., :0], counts, 8, FILL_G)
    with pytest.raises(ValueError, match="unsupported device"):
        fp.flat_pairs(grow.to("meta"), cand.to("meta"), counts.to("meta"),
                      8, FILL_G)
