"""The shard group: the counterpart of the JAX package's mesh axis.

The JAX engine runs one ``shard_map`` program over a mesh of N devices,
which under ``jax.distributed`` spans P processes of L local devices
each.  Here a :class:`ShardGroup` holds this process's shards (one
``torch.device`` each; shards may share a device) and, optionally, a
``torch.distributed`` process group.  The global shard order is
process-major, then local order: the order of JAX's
``all_gather(tiled=True)`` over ``jax.devices()[:n]``, which the device
BBH's row positions rely on.

A sharded array is a list of tensors, one per local shard, each on its
shard's device.  A per-shard program with collectives is a generator
that yields ``(op, tensor)`` at each collective and receives the
result; :meth:`ShardGroup.spmd` runs the local shards' programs in
lockstep (in a thread each when the shards sit on distinct cards, so
that one card's host syncs do not hold back the others).  Collectives
move tensors between local devices by copies and, across processes,
through ``torch.distributed`` (NCCL for CUDA tensors, gloo for CPU
ones); no CUDA tensor goes through the host.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from pandelos_tpu_torch import tracing
from pandelos_tpu_torch.parallel.distributed import first_card, world


class ShardGroup:
    """This process's shard devices and the process group spanning every
    process's shards (None: one process)."""

    def __init__(self, devices: Sequence, group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a shard group needs at least one shard")
        self.group = group
        if group is not None:
            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        else:
            self.rank, self.world = 0, 1
        self.n_local = len(self.devices)
        self.n = self.world * self.n_local
        self.first = self.rank * self.n_local  # global index of local 0
        self._pool = None

    def __repr__(self):
        return (f"ShardGroup({[str(d) for d in self.devices]}, rank "
                f"{self.rank} of {self.world})")

    @property
    def key(self) -> tuple:
        """What identifies the group for caches."""
        return (tuple(str(d) for d in self.devices), self.rank, self.world)

    # --- placement ------------------------------------------------------
    def replicate(self, arr) -> List[torch.Tensor]:
        """``arr`` (NumPy or a tensor) on every local shard's device; shards
        that share a device share the tensor."""
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        on = {}
        for d in self.devices:
            if d not in on:
                on[d] = arr.to(d)
        return [on[d] for d in self.devices]

    def shard0(self, arr) -> List[torch.Tensor]:
        """This process's slices of ``arr`` split in ``n`` equal parts
        along axis 0, each on its shard's device."""
        if isinstance(arr, np.ndarray):
            arr = torch.from_numpy(np.ascontiguousarray(arr))
        if arr.shape[0] % self.n:
            raise ValueError(f"axis 0 of {tuple(arr.shape)} does not split "
                             f"over {self.n} shards")
        s = arr.shape[0] // self.n
        return [arr[(self.first + i) * s:(self.first + i + 1) * s].to(d)
                for i, d in enumerate(self.devices)]

    # --- collectives ----------------------------------------------------
    def _gather_first(self, ts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's tensor concatenated along axis 0 in global shard
        order, on the first local device."""
        d0 = self.devices[0]
        shapes = {tuple(t.shape) for t in ts}
        if len(shapes) != 1:
            raise ValueError(f"shards differ in shape: {sorted(shapes)}")
        local = torch.cat([t.to(d0) for t in ts]) if len(ts) > 1 \
            else ts[0].to(d0)
        if self.group is None:
            return local
        is_bool = local.dtype == torch.bool
        send = local.to(torch.uint8) if is_bool else local.contiguous()
        out = torch.empty((self.world * send.shape[0],) + send.shape[1:],
                          dtype=send.dtype, device=d0)
        dist.all_gather_into_tensor(out, send, group=self.group)
        return out.bool() if is_bool else out

    def all_gather(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Tiled all_gather along axis 0: every local shard gets the
        global concatenation on its device."""
        return self.replicate(self._gather_first(ts))

    def _reduce(self, ts, op: str) -> List[torch.Tensor]:
        d0 = self.devices[0]
        fn = torch.maximum if op == "max" else torch.minimum
        acc = ts[0].to(d0).clone()
        for t in ts[1:]:
            acc = fn(acc, t.to(d0))
        if self.group is not None:
            dist.all_reduce(acc, op=dist.ReduceOp.MAX if op == "max"
                            else dist.ReduceOp.MIN, group=self.group)
        return self.replicate(acc)

    def pmax(self, ts) -> List[torch.Tensor]:
        """Elementwise max over every shard, on every local shard."""
        return self._reduce(ts, "max")

    def pmin(self, ts) -> List[torch.Tensor]:
        """Elementwise min over every shard, on every local shard."""
        return self._reduce(ts, "min")

    def max_int(self, values: Sequence[int]) -> int:
        """The largest of every shard's integer, on every process."""
        m = max(int(v) for v in values)
        if self.group is None:
            return m
        t = torch.tensor([m], dtype=torch.int64, device=self.devices[0])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return tracing.to_int(t)

    def ring_shift(self, ts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """JAX's ``ppermute`` i -> (i - 1) mod n: global shard i receives
        the tensor of shard (i + 1) mod n.  Within a process by copies;
        the boundary shards cross processes by ``batch_isend_irecv``."""
        out = [ts[i + 1].to(d) for i, d in enumerate(self.devices[:-1])]
        if self.group is None or self.world == 1:
            return out + [ts[0].to(self.devices[-1])]
        send = ts[0].contiguous()
        recv = torch.empty_like(send)
        ranks = dist.get_process_group_ranks(self.group)
        ops = [
            dist.P2POp(dist.isend, send,
                       ranks[(self.rank - 1) % self.world], self.group),
            dist.P2POp(dist.irecv, recv,
                       ranks[(self.rank + 1) % self.world], self.group),
        ]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out + [recv.to(self.devices[-1])]

    def fetch(self, ts: Sequence[torch.Tensor], axis: int = 0) -> np.ndarray:
        """A sharded array (the local shards' tensors) to host NumPy as
        the global concatenation along ``axis``, on every process; the
        copy to the host counts as a wait on the card (``tracing``)."""
        if axis:
            ts = [t.movedim(axis, 0).contiguous() for t in ts]
        whole = self._gather_first(ts)
        with tracing.blocked():
            out = whole.cpu().numpy()
        return np.moveaxis(out, 0, axis) if axis else out

    def fetch_many(self, *arrays) -> list:
        """:meth:`fetch` of several sharded arrays.  Every shard's work is
        launched before this is called; the first copy blocks only on its
        own device."""
        return [self.fetch(ts) for ts in arrays]

    # --- per-shard programs ---------------------------------------------
    _OPS = {"all_gather", "pmax", "pmin", "ring_shift", "max_int"}

    def _parallel(self) -> bool:
        cards = [d for d in self.devices if d.type == "cuda"]
        return len(cards) == self.n_local and len(set(cards)) > 1

    def map(self, fn, items) -> list:
        """``[fn(x) for x in items]``, one item a local shard: in a thread
        each when the local shards sit on distinct cards (the threads'
        waits on their cards are added to the current spans, summed)."""
        if not self._parallel():
            return [fn(x) for x in items]
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.n_local)
        done = list(self._pool.map(tracing.worker(fn), items))
        tracing.add_waits([tally for _, tally in done])
        return [value for value, _ in done]

    def spmd(self, programs) -> list:
        """Run the local shards' programs (generators, one per local
        shard, in local order) in lockstep: each runs to its next
        ``yield (op, value)``; when all have, the collective ``op`` (one
        of ``all_gather``, ``pmax``, ``pmin``, ``ring_shift``,
        ``max_int``) runs over the values and each program receives its
        result.  Returns the programs' return values."""
        gens = list(programs)
        if len(gens) != self.n_local:
            raise ValueError(f"{len(gens)} programs for {self.n_local} "
                             f"local shards")

        def advance(arg):
            g, value = arg
            try:
                return False, g.send(value)
            except StopIteration as stop:
                return True, stop.value

        sent = [None] * len(gens)
        while True:
            steps = self.map(advance, zip(gens, sent))
            done = [d for d, _ in steps]
            if all(done):
                return [v for _, v in steps]
            if any(done):
                raise RuntimeError("shard programs left their lockstep")
            ops = {m[0] for _, m in steps}
            if len(ops) != 1 or not ops <= self._OPS:
                raise RuntimeError(f"shard programs disagree on the "
                                   f"collective: {sorted(map(str, ops))}")
            op = ops.pop()
            sent = getattr(self, op)([m[1] for _, m in steps])
            if op == "max_int":
                sent = [sent] * len(gens)


def resolve_n_devices(config) -> int:
    """``config.n_devices``, or by default one shard a process (every
    process of a ``torch.distributed`` run, one otherwise): the JAX
    package's ``_resolve_n_devices``."""
    if config.n_devices is not None:
        return config.n_devices
    return world()[1]


def resolve_shards(config, device=None, devices=None) -> ShardGroup:
    """The shard group of a run.  ``devices`` (a list, one entry a
    shard) puts the shards where it says; it is the testing counterpart
    of JAX's virtual devices (four shards on one card), not a user
    option.  Otherwise ``resolve_n_devices(config)`` shards in all, as
    many in each process: on the CPU (``device`` or ``config.device``
    ``"cpu"``), n CPU shards; on CUDA, process r's shards take cards r*L
    .. r*L + L - 1 modulo the card count (``cuda:0 .. n-1`` in one
    process), and more shards in a process than cards raises
    ValueError.  One shard in one process takes the device as given."""
    from pandelos_tpu_torch.device import resolve_device

    group = dist.group.WORLD if dist.is_initialized() else None
    rank, n_proc = world()
    if devices is not None:
        return ShardGroup([resolve_device(d) for d in devices], group)
    n = max(1, resolve_n_devices(config))
    if n % n_proc:
        raise ValueError(f"n_devices={n} does not split over {n_proc} "
                         f"processes")
    L = n // n_proc
    kind = torch.device(device if device is not None else config.device)
    if n == 1 and group is None:
        return ShardGroup([resolve_device(kind)])
    if kind.type == "cuda":
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if L > count:
            raise ValueError(
                f"config requests n_devices={n} ({L} in this process) but "
                f"only {count} CUDA device(s) exist; pass devices= to put "
                f"several shards on one card")
        first = first_card(rank, n_proc, n, count)
        return ShardGroup([torch.device("cuda", (first + i) % count)
                           for i in range(L)], group)
    return ShardGroup([resolve_device(kind)] * L, group)

