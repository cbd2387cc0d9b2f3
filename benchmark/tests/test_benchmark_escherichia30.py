"""The ``escherichia30`` configuration, found by its cell's name: one chip,
``n_genomes`` its only cut, listed under every span metric of the device
engine but ``index_native_s``, and a generator that gives its 141,279
genes of 32-3,240 residues."""

from benchmark import harness, jobs


def test_the_escherichia30_cell_loads_by_name():
    cell = harness.load_cell("escherichia30.full")
    assert cell.chips == 1 and cell.config["name"] == "escherichia30"
    assert cell.config["reduced"] == ["n_genomes"]
    assert cell.config["generator"]["n_genomes"] == 30
    names = {m["name"] for m in cell.per_layer}
    assert {"heavy_rows_s", "engine_s", "pad_s"} <= names
    assert "index_native_s" not in names
    ds = jobs.dataset(cell.config, 2**33 + 5)
    assert ds.n_sequences == 141279 and ds.n_genomes == 30
    lengths = [len(s) for s in ds.sequences]
    assert min(lengths) == 32 and max(lengths) == 3240
