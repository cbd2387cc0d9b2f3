"""The benchmark's plain reference of a whole PanDelos job: from a
``.faa`` to the BBH network (``network.py``) and the gene families
(``netclu.py``), in NumPy and plain PyTorch; ``job.py`` runs it.  It
imports nothing of the program and takes nothing the program made."""
