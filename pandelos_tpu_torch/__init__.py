"""PanDelos on PyTorch and CUDA: the port of ``pandelos_tpu`` to one
NVIDIA H100.

The JAX package ``pandelos_tpu`` stays beside this one as the reference.
This package imports nothing of it (nor JAX): it keeps its own copies of
the host layers (``io/``, ``index.py``, ``native/``, ``ksel.py``,
``oracle/``, ``net.py``, ``cluster.py``, ``bench/``, ``dictionaries.py``,
``reference.py``) and ports the device paths to torch, with the exact
profile joins as hand-written CUDA kernels (``csrc/``).  It runs every
backend and CLI command of the JAX package on one card; the multi-device
options are not ported yet.  Entry points run on the card unless the
caller asks for the CPU (``device="cpu"``), where every kernel wrapper
takes its plain PyTorch version.
"""

__version__ = "0.1.0"

from pandelos_tpu_torch.config import PipelineConfig  # noqa: F401
