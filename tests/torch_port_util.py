"""Helpers shared by the tests that hold the PyTorch port against the JAX
package on the same inputs."""

import dataclasses

from pandelos_tpu.index import build_index as jax_build_index
from pandelos_tpu_torch.index import KmerIndex as TorchKmerIndex


def twin_indexes(ds, k):
    """(JAX index, port index) holding the very same arrays, each with its
    own memo caches."""
    jidx = jax_build_index(ds, k=k)
    tidx = TorchKmerIndex.from_arrays(dataclasses.asdict(jidx))
    return jidx, tidx

