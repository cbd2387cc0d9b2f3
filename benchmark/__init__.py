"""The benchmark of ``pandelos_tpu_torch``: whole ``.faa`` -> ``.net`` +
``.clus`` jobs on one card (``run.py``; ``BENCHMARK.json`` at the root of
the repository lists its cells)."""
