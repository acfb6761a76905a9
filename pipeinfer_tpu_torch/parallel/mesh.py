"""A device mesh and the three collectives of the JAX package's shard_map
programs, for the port.

The JAX package runs its multi-device programs as single-controller SPMD:
``shard_map`` over a ``jax.sharding.Mesh``, with ``all_gather``, ``psum``
and ``ppermute`` between the per-device bodies. The port writes that out.
A ``Mesh`` names the axes of a grid of ``torch.device``s, and each grid
coordinate carries the rank of the process that owns it (0 everywhere in
one process). A device may repeat: ``["cpu"] * 8`` in the tests and
``[cuda:0] * 4`` on one card put several shards on one device, as the
JAX tests put them on virtual CPU devices.

A shard_map body becomes a loop over this process's local coordinates
(``Mesh.local``) between collectives. The collectives take one tensor per
coordinate and return one per coordinate, each on that coordinate's
device:

- within a process they are copies to the consumer's device followed by
  a concatenation or a sum in shard order (peer copies between cards), so
  every consumer gets the same bits;
- where an axis crosses processes, every process hands its local tensors
  to one ``torch.distributed.all_gather`` (gloo on the CPU and for
  processes that share a card, whose tensors go through the host; nccl
  only where each rank owns its own card) and then does the same
  concatenation or sum. Every process must call the collective, in the
  same order, as SPMD programs do.

No kernel runs here: the kernels stay in ops/ and the collectives outside
them, as the hopper-kernels translation table has them.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..device import resolve


def default_devices(n: int) -> list[torch.device]:
    """n devices round-robin over the CUDA cards of this process
    (``cuda:i % device_count``): on one card every entry is ``cuda:0``.
    Raises without CUDA, as every entry point of the port does."""
    resolve("cuda")
    return [torch.device(f"cuda:{i % torch.cuda.device_count()}") for i in range(n)]


def process_rank() -> int:
    """This process's rank in torch.distributed (0 when it is not set up)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


class Mesh:
    """Named axes over a grid of devices, each coordinate owned by a process.

    devices: a nested sequence (or array) of devices or device names whose
    shape is the mesh's; ranks: the owning process of each coordinate, the
    same shape (default all 0). Only this process's coordinates are
    resolved to devices it can use."""

    def __init__(self, devices, axis_names: Sequence[str], ranks=None):
        given = np.asarray(devices, dtype=object)
        names = np.empty(given.shape, dtype=object)
        for idx in np.ndindex(names.shape):
            names[idx] = str(given[idx])
        if names.ndim != len(axis_names):
            raise ValueError(f"{names.ndim}-d device grid for axes {tuple(axis_names)}")
        self.axis_names = tuple(axis_names)
        self.ranks = (np.zeros(names.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(names.shape))
        self.rank = process_rank() if self.ranks.any() else 0
        self.local = [c for c in np.ndindex(names.shape) if self.ranks[c] == self.rank]
        if not self.local:
            raise ValueError(f"process {self.rank} owns no coordinate of the mesh")
        counts = np.bincount(self.ranks.ravel())
        if len(set(counts[counts > 0])) > 1:
            raise ValueError(f"uneven mesh: processes own {counts.tolist()} coordinates "
                             "(the cross-process collectives need an even split)")
        self.devices = np.empty(names.shape, dtype=object)
        for c in np.ndindex(names.shape):
            self.devices[c] = resolve(names[c]) if self.ranks[c] == self.rank else names[c]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def local_devices(self) -> list[torch.device]:
        return [self.devices[c] for c in self.local]

    def index(self, coord: tuple, axis: str) -> int:
        """coord's position along `axis`."""
        return coord[self.axis_names.index(axis)]

    def group(self, coord: tuple, axis: str) -> list[tuple]:
        """The coordinates that share every index of coord but the one
        along `axis`, in axis order: coord's group in a collective."""
        a = self.axis_names.index(axis)
        return [coord[:a] + (i,) + coord[a + 1:] for i in range(self.devices.shape[a])]

    def spans_processes(self, axis: str) -> bool:
        """Whether some group along `axis` holds coordinates of two
        processes (its collectives then go through torch.distributed)."""
        a = self.axis_names.index(axis)
        return bool((self.ranks != self.ranks.take([0], axis=a)).any())

    def replicate(self, t: torch.Tensor | None, coords: Sequence[tuple] | None = None) -> list:
        """t on the device of each coordinate (default: every local one);
        coordinates on t's device share t itself."""
        coords = self.local if coords is None else coords
        return [None if t is None else t.to(self.devices[c]) for c in coords]

    # -- collectives ----------------------------------------------------------

    def _table(self, xs: Sequence[torch.Tensor], axis: str,
               coords: Sequence[tuple] | None) -> dict[tuple, torch.Tensor]:
        """Every member's tensor of every group the coordinates `coords`
        (default all local ones) belong to along `axis`, keyed by
        coordinate."""
        coords = list(self.local if coords is None else coords)
        if len(xs) != len(coords):
            raise ValueError(f"{len(xs)} tensors for {len(coords)} coordinates")
        if not self.spans_processes(axis):
            return dict(zip(coords, xs))
        if coords != self.local:
            raise ValueError(f"a collective over '{axis}' crosses processes: every local "
                             "coordinate takes part")
        return self._exchange(xs)

    def _exchange(self, xs: Sequence[torch.Tensor]) -> dict[tuple, torch.Tensor]:
        """Every coordinate's tensor, from every process: one all_gather of
        each process's stacked local tensors (all of one shape and type)."""
        import torch.distributed as dist

        # gloo moves host tensors only; nccl the rank's own card's
        dev = xs[0].device if dist.get_backend() == "nccl" else torch.device("cpu")
        mine = torch.stack([x.to(dev) for x in xs])
        bufs = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
        dist.all_gather(bufs, mine.contiguous())
        table = {}
        for r, buf in enumerate(bufs):
            owned = [c for c in np.ndindex(self.devices.shape) if self.ranks[c] == r]
            table.update(zip(owned, buf))
        return table

    def all_gather(self, xs: Sequence[torch.Tensor], axis: str, dim: int,
                   coords: Sequence[tuple] | None = None) -> list[torch.Tensor]:
        """Tiled all_gather: each coordinate gets its group's tensors
        concatenated along `dim` in axis order (jax.lax.all_gather(x, axis,
        axis=dim, tiled=True))."""
        coords = self.local if coords is None else coords
        table = self._table(xs, axis, coords)
        out = []
        for c in coords:
            dev = self.devices[c]
            out.append(torch.cat([table[m].to(dev) for m in self.group(c, axis)], dim=dim))
        return out

    def psum(self, xs: Sequence[torch.Tensor], axis: str,
             coords: Sequence[tuple] | None = None) -> list[torch.Tensor]:
        """Each coordinate gets its group's sum, added in axis order (the
        same bits on every member)."""
        coords = self.local if coords is None else coords
        table = self._table(xs, axis, coords)
        out = []
        for c in coords:
            dev = self.devices[c]
            members = self.group(c, axis)
            acc = table[members[0]].to(dev, copy=True)
            for m in members[1:]:
                acc += table[m].to(dev)
            out.append(acc)
        return out

    def ppermute(self, xs: Sequence[torch.Tensor], axis: str, perm: Sequence[tuple[int, int]],
                 coords: Sequence[tuple] | None = None) -> list[torch.Tensor]:
        """Each coordinate at index d along `axis` gets the tensor of the
        member at index s for each (s, d) in perm, and zeros where no pair
        ends at d (jax.lax.ppermute)."""
        coords = self.local if coords is None else coords
        table = self._table(xs, axis, coords)
        src = {d: s for s, d in perm}
        a = self.axis_names.index(axis)
        out = []
        for c, x in zip(coords, xs):
            i = c[a]
            if i in src:
                out.append(table[c[:a] + (src[i],) + c[a + 1:]].to(self.devices[c], copy=True))
            else:
                out.append(torch.zeros_like(x))
        return out

    def __repr__(self) -> str:
        grid = ", ".join(f"{n}={s}" for n, s in self.shape.items())
        devs = sorted({str(d) for d in self.local_devices})
        return f"Mesh({grid}; rank {self.rank} holds {len(self.local)} on {devs})"


def groups_of(coords: Sequence[tuple], mesh: Mesh, axis: str) -> list[list[tuple]]:
    """`coords` cut into their groups along `axis` (each in axis order),
    keeping only groups all of whose members are in `coords`."""
    have = set(coords)
    seen, out = set(), []
    for c in coords:
        g = tuple(mesh.group(c, axis))
        if g not in seen and all(m in have for m in g):
            seen.add(g)
            out.append(list(g))
    return out

