"""Typed configuration for the whole pipeline.

The reference scatters configuration across three layers (bash positional
args + ``PANDELOS_PATH`` env at ``pandelos.sh:16-22,44-57``, Apache
commons-cli in ``Cli.java:11-57``, structopt in
``benchmark/test-framework/src/main.rs:22-79``).  Here a single dataclass
covers all of it.

The fields are those of the JAX package's ``PipelineConfig`` that this
package reads (its dense-backend and mesh fields are left out), plus
``device``.  This package runs the ``"cuda"``
engine (the candidate engine with its three exact joins, and the BBH
network on the device or on the host) and the ``"oracle"`` host path;
options of paths that are not ported yet raise :class:`NotPortedError`
from :func:`check_ported`, naming the ROADMAP queue item that ports them.
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
    backend: str = "cuda"  # "cuda" | "oracle"
    # torch device of the "cuda" engine: "cuda" (default; raises when no
    # card is present) or "cpu" (the tests' route through the kernels'
    # plain versions)
    device: str = "cuda"
    # Row-block height of the candidate extraction (the reference analogue
    # is the 2048-wide column stepping at library.cpp:453-458).
    row_block: int = 256
    # Column-block width; with row_block it sets the padded gene count.
    col_block: int = 2048
    # --- candidate engine (ops/candidate.py)
    # Max candidate columns per row on device; the BBH path doubles it
    # until no row overflows (up to 1024).
    candidate_cap: int = 128
    # Run the BBH network construction on device (None and True: on;
    # False: the cells path, compute_cells_candidate + host BBH, which
    # also takes over when a row's candidates pass MAX_CANDIDATE_CAP).
    device_bbh: Optional[bool] = None
    # Exact-join kernel, each a hand-written CUDA kernel: "lane2" (packed
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

    # --- observability (JAX profiler trace directory: not ported)
    profile_dir: Optional[str] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "PipelineConfig":
        return PipelineConfig(**json.loads(s))


JOIN_KERNELS = ("lane2", "lane", "roll")

# backends of the JAX package and the ROADMAP item that ports each
_BACKEND_QUEUE = {
    "xla": "ROADMAP Queue 1 item 8 (the xla backend's in-scan join)",
    "dense": "ROADMAP Queue 1 item 8 (the dense backend)",
    "pallas": "ROADMAP Queue 1 item 8 (the JAX package's backend names); "
    "its pallas route is this package's backend 'cuda', device_bbh=False "
    "its cells path",
    "auto": "in the JAX package 'auto' is the xla backend, ROADMAP Queue 1 "
    "item 8; the engine of this package is backend 'cuda'",
    "reference": "ROADMAP Queue 4 item 1 (the reference transcription "
    "backend)",
}


def check_ported(config: PipelineConfig) -> None:
    """Raise :class:`NotPortedError` for any option whose path is not
    ported yet; never run another path in its place."""
    b = config.backend
    if b in _BACKEND_QUEUE:
        raise NotPortedError(
            f"backend {b!r} is not ported: {_BACKEND_QUEUE[b]}"
        )
    if b not in ("cuda", "oracle"):
        raise ValueError(f"unknown backend: {b}")
    if config.profile_dir:
        raise NotPortedError(
            "profile_dir is not ported: ROADMAP Queue 4 item 2 (a "
            "torch.profiler trace of the score phase)"
        )
    if b == "oracle":
        return
    if config.n_devices is not None and config.n_devices > 1:
        raise NotPortedError(
            f"n_devices={config.n_devices} is not ported: ROADMAP Queue 1 "
            "item 9 (multi-GPU)"
        )
    if config.ring_extract:
        raise NotPortedError(
            "ring_extract is not ported: ROADMAP Queue 1 item 9 (ring mode)"
        )
    if config.join_kernel not in JOIN_KERNELS:
        raise ValueError(
            f"unknown join_kernel {config.join_kernel!r}: one of "
            f"{JOIN_KERNELS}"
        )
