"""Typed configuration for the whole pipeline.

The reference scatters configuration across three layers (bash positional
args + ``PANDELOS_PATH`` env at ``pandelos.sh:16-22,44-57``, Apache
commons-cli in ``Cli.java:11-57``, structopt in
``benchmark/test-framework/src/main.rs:22-79``).  Here a single dataclass
covers all of it.

The fields are those of the JAX package's ``PipelineConfig`` that this
package reads (its ``mesh_axis`` is left out), plus ``device``.  Backends
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

``n_devices`` shards the candidate engine's row blocks (backends
``"cuda"`` and ``"xla"``; ``"dense"`` and the host backends ignore it)
over that many devices, or processes under ``torch.distributed``
(:mod:`pandelos_tpu_torch.parallel`).  ``ring_extract`` shards the
signatures too and rotates them (``ops/ring.py``) where the JAX package
does: the device BBH takes the ring under backend ``"cuda"`` over two
shards or more and the replicated engine otherwise; the cells path
(``device_bbh=False``) takes it under ``"cuda"`` and ``"xla"`` alike
(with the join kernel) and raises ValueError on one shard; ``"dense"``,
``"oracle"`` and ``"reference"`` ignore it.  Every option combination
runs what the JAX package runs; :func:`check_ported` rejects only
unknown option values.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


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
    # until no row overflows (up to 1024; rows past that take its
    # heavy-row pass).
    candidate_cap: int = 128
    # Run the BBH network construction on device for the "cuda" and
    # "xla" backends (None and True: on; False: the cells path,
    # compute_cells_candidate + host BBH, which also takes over when the
    # card cannot hold the heavy-row pass of rows whose candidates pass
    # MAX_CANDIDATE_CAP).
    device_bbh: Optional[bool] = None
    # Exact-join kernel of the "cuda" backend, each a hand-written CUDA
    # kernel: "lane2" (packed
    # lane table; falls back to "lane" when a k-mer count >= 256 or the
    # vocabulary >= 2^23), "lane" (unpacked lane table) or "roll" (the
    # sorted join over the padded profiles).
    join_kernel: str = "lane2"
    # Ring-sharded extraction (ops/ring.py): signatures sharded over the
    # devices and rotated instead of replicated, the memory-scaling mode
    # for inputs whose replicated signatures do not fit one card; the
    # cells are the same.  Taken where ring_engaged() says (device BBH)
    # and by the cells path of "cuda" and "xla" (two shards or more).
    ring_extract: bool = False

    # --- parallelism
    # Shards of the candidate engine's row blocks (ops/candidate.py,
    # parallel/shards.py): None -> one shard a process (one device in a
    # single process, every process under torch.distributed).  On
    # device "cuda" the shards take cuda:0..n-1; on "cpu", n CPU shards.
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
    # When set, the whole job runs under a torch.profiler trace written to
    # this directory, its spans as pandelos.* ranges, with a summary of
    # the card's busy share (pandelos_tpu_torch/profiling.py).
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


def resolve_backend(backend: str) -> str:
    """The backend a run takes: the JAX package's ``"auto"`` is ``"xla"``
    (as in its ``pipeline._resolve_backend``) and its ``"pallas"`` is this
    package's ``"cuda"`` engine."""
    return _ALIASES.get(backend, backend)


def ring_engaged(config: PipelineConfig, n_shards: int) -> bool:
    """Whether the device BBH runs the ring: ``ring_extract`` under
    backend ``"cuda"`` over two shards or more, else the replicated
    engine (the JAX package's ``use_ring``, ``ops/net_device.py``)."""
    return (bool(config.ring_extract)
            and resolve_backend(config.backend) == "cuda"
            and n_shards >= 2)


def check_ported(config: PipelineConfig) -> None:
    """Raise ValueError for an unknown backend, ``join_kernel`` or
    ``matmul_dtype``, as the JAX package does.  Every combination of
    known values runs; the engines that take ``ring_extract`` and
    ``n_devices`` decide, as the JAX package's do, whether those apply
    (see the module docstring)."""
    if config.backend not in BACKENDS:
        raise ValueError(f"unknown backend: {config.backend}")
    if resolve_backend(config.backend) in ("oracle", "reference"):
        return
    if config.join_kernel not in JOIN_KERNELS:
        raise ValueError(
            f"unknown join_kernel {config.join_kernel!r}: one of "
            f"{JOIN_KERNELS}"
        )
    if config.matmul_dtype not in ("bf16", "f32"):
        raise ValueError(f"unknown matmul_dtype: {config.matmul_dtype}")
