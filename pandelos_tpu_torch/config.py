"""Typed configuration for the whole pipeline.

The reference scatters configuration across three layers (bash positional
args + ``PANDELOS_PATH`` env at ``pandelos.sh:16-22,44-57``, Apache
commons-cli in ``Cli.java:11-57``, structopt in
``benchmark/test-framework/src/main.rs:22-79``).  Here a single dataclass
covers all of it.

The fields are those of the JAX package's ``PipelineConfig`` that this
package reads (its mesh fields are left out), plus ``device``.  Backends
(:func:`resolve_backend` maps the JAX package's names):

- ``"cuda"`` (default; the JAX ``"pallas"``): the candidate engine with
  its three hand-written exact joins, the BBH network on the device or
  on the host;
- ``"xla"`` (what ``"auto"`` means, as in the JAX package): the same
  candidate engine with the in-scan join (array code, no join kernel),
  the BBH network on the device over its [rows, K] outputs or on the
  host;
- ``"dense"``: the blocked-matmul scorer (``ops/score.py``), host BBH;
- ``"oracle"``: the host posting walk;
- ``"reference"``: the whole-run transcription twin
  (:mod:`pandelos_tpu_torch.reference`), on the host; ``device`` does not
  change it.

The multi-GPU options (``n_devices`` > 1, ``ring_extract``) are not
ported yet: they raise :class:`NotPortedError` from :func:`check_ported`,
naming the ROADMAP queue item that ports them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


class NotPortedError(NotImplementedError):
    """A path of the JAX package that this package does not run yet."""


@dataclasses.dataclass
class PipelineConfig:
    # --- k selection (-k/--kvalue in Cli.java:21-24; auto as calculate_k.py)
    k: Optional[int] = None  # None -> derive via entropy formula

    # --- scoring backend
    # "cuda" | "xla" | "dense" | "oracle", and the JAX names "pallas"
    # (= "cuda") and "auto" (= "xla")
    backend: str = "cuda"
    # torch device of the device backends: "cuda" (default; raises when
    # no card is present) or "cpu" (the tests' route through the
    # kernels' plain versions)
    device: str = "cuda"
    # Row-block height of the candidate extraction and the dense pass (the
    # reference analogue is the 2048-wide column stepping at
    # library.cpp:453-458).
    row_block: int = 256
    # Column-block width; with row_block it sets the padded gene count.
    col_block: int = 2048
    # --- dense backend (ops/score.py)
    # Count-level cap of the min-sum level decomposition; per-(gene, kmer)
    # counts above it get exact host corrections.
    level_cap: int = 4
    # Operand dtype of the dense matmuls: "bf16" (f32 results) or "f32".
    matmul_dtype: str = "bf16"
    # Cells extracted per row block = nnz_cap_per_row * row_block; a
    # block past it is rerun with its exact count.
    nnz_cap_per_row: int = 512
    # --- candidate engine (ops/candidate.py)
    # Max candidate columns per row on device; the BBH path doubles it
    # until no row overflows (up to 1024).
    candidate_cap: int = 128
    # Run the BBH network construction on device for the "cuda" and
    # "xla" backends (None and True: on; False: the cells path,
    # compute_cells_candidate + host BBH, which also takes over when a
    # row's candidates pass MAX_CANDIDATE_CAP).
    device_bbh: Optional[bool] = None
    # Exact-join kernel of the "cuda" backend, each a hand-written CUDA
    # kernel: "lane2" (packed
    # lane table; falls back to "lane" when a k-mer count >= 256 or the
    # vocabulary >= 2^23), "lane" (unpacked lane table) or "roll" (the
    # sorted join over the padded profiles).
    join_kernel: str = "lane2"
    # Ring-sharded extraction (multi-device): not ported.
    ring_extract: bool = False

    # --- parallelism (one device only in this package)
    n_devices: Optional[int] = None

    # --- complexity / dry-run mode (-c/--complexity, Cli.java:30-35)
    only_complexity: bool = False

    # --- outputs
    write_net: bool = True
    write_clus: bool = True
    # Also write <out>.report: the netclu per-family F{ }/D{ }/S{ } stream
    # (netclu_ng.py:117-138) for consumers of the raw netclu output.
    write_report: bool = False
    # Keep phase checkpoints (.net is the reference's de-facto checkpoint,
    # pandelos.sh:73-76); allows resuming clustering without rescoring.
    checkpoint_dir: Optional[str] = None

    # --- observability
    # When set, the score and network phases run under a torch.profiler
    # trace written to this directory with a summary of the card's busy
    # share (pandelos_tpu_torch/profiling.py).
    profile_dir: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "PipelineConfig":
        return PipelineConfig(**json.loads(s))


JOIN_KERNELS = ("lane2", "lane", "roll")

BACKENDS = ("cuda", "xla", "dense", "oracle", "reference", "pallas",
            "auto")
# the JAX package's backend names that name a backend of this package
_ALIASES = {"pallas": "cuda", "auto": "xla"}
# the ROADMAP item that ports the multi-GPU paths
MULTI_GPU_ITEM = "ROADMAP Queue 1 item 1 (multi-GPU)"


def resolve_backend(backend: str) -> str:
    """The backend a run takes: the JAX package's ``"auto"`` is ``"xla"``
    (as in its ``pipeline._resolve_backend``) and its ``"pallas"`` is this
    package's ``"cuda"`` engine."""
    return _ALIASES.get(backend, backend)


def check_ported(config: PipelineConfig) -> None:
    """Raise :class:`NotPortedError` for any option whose path is not
    ported yet; never run another path in its place."""
    if config.backend not in BACKENDS:
        raise ValueError(f"unknown backend: {config.backend}")
    b = resolve_backend(config.backend)
    if b in ("oracle", "reference"):
        return
    if config.n_devices is not None and config.n_devices > 1:
        raise NotPortedError(
            f"n_devices={config.n_devices} is not ported: {MULTI_GPU_ITEM}"
        )
    if config.ring_extract:
        raise NotPortedError(
            f"ring_extract is not ported: {MULTI_GPU_ITEM}, ring mode"
        )
    if config.join_kernel not in JOIN_KERNELS:
        raise ValueError(
            f"unknown join_kernel {config.join_kernel!r}: one of "
            f"{JOIN_KERNELS}"
        )
    if config.matmul_dtype not in ("bf16", "f32"):
        raise ValueError(f"unknown matmul_dtype: {config.matmul_dtype}")
