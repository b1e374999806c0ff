"""A mesh of torch devices, its collectives, and state split over it.

Counterpart of ``make_mesh``/``AXIS`` (badslam_tpu/parallel/sharded.py) and
of the shard_map plumbing of badslam_tpu/parallel/streamed.py. The JAX
package is single-controller SPMD: one Python process, a ``Mesh``, and
``shard_map`` bodies joined by XLA collectives. The port keeps that model
with one process and no process group: the mesh is an ordered tuple of
torch devices (axis "d"), a sharded value is a list with one tensor per
shard, and a collective is a plain function over such a list. Each
collective copies to the destination shard's device with ``.to()`` (a
no-op where the devices are the same) and reduces in shard order, so a
run is repeatable. Shards may share a device: a CPU mesh holds its shards
on the one CPU device (the counterpart of the 8 virtual CPU devices the
JAX tests force), and an explicit device list may repeat a card.

State over the mesh:
  * ``ShardedMap``: the surfel rows [0, rows) in D contiguous blocks of
    ceil(rows / D) rows, block i on device i (the last block padded with
    invalid rows); every block carries the global ``count``;
  * ``Planes``: the keyframe planes, replicated (every device holds all
    slots) or streamed (shard i holds the slots [i K/D, (i+1) K/D) of the
    K-slot store); a stage reads a keyframe batch through ``take``, a local
    read, or in the streamed layout the broadcast from the owning shard
    (``bcast_chunk``, the masked psum of streamed.py:70-100).
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Sequence

import torch

from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import KeyframeStack, index_of
from badslam_torch.mapping.surfels import SurfelMap
from badslam_torch.ops import kernels

AXIS = "d"
PLANE_NAMES = ("depth", "nx", "ny", "radius2", "intensity", "rgb")


class Mesh:
    """An ordered tuple of torch devices, one per shard, along axis "d"."""

    def __init__(self, devices: Sequence):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        return self.devices[0]

    def distinct(self) -> List[torch.device]:
        """The distinct devices, in shard order."""
        return list(dict.fromkeys(self.devices))

    def __repr__(self) -> str:
        return f"Mesh({', '.join(str(d) for d in self.devices)})"


def make_mesh(n_devices: int = None, device="cuda", devices=None) -> Mesh:
    """`devices` as given (a list that may repeat a device), or n_devices
    shards: on "cpu" all on the one CPU device, on "cuda" shard i on
    cuda:i, raising RuntimeError when fewer cards are visible."""
    if devices is not None:
        return Mesh(devices)
    if n_devices is None or n_devices < 1:
        raise ValueError(f"make_mesh: n_devices must be at least 1, got {n_devices}")
    device = torch.device(device)
    if device.type == "cpu":
        return Mesh([device] * n_devices)
    if device.type == "cuda":
        visible = torch.cuda.device_count()
        if visible < n_devices:
            raise RuntimeError(f"n_devices={n_devices} but only {visible} CUDA "
                               f"devices are visible")
        return Mesh([torch.device("cuda", i) for i in range(n_devices)])
    raise ValueError(f"make_mesh: unsupported device type {device.type}")


@contextlib.contextmanager
def on_shard(i: int):
    """Work of shard i: its kernel launches are counted under tag i."""
    with kernels.launch_tag(i):
        yield


# ---------------------------------------------------------------------------
# Collectives over per-shard lists (fixed shard order on every device)
# ---------------------------------------------------------------------------


def _reduce(mesh: Mesh, xs: Sequence[torch.Tensor], op) -> List[torch.Tensor]:
    out = {}
    for dev in mesh.distinct():
        acc = xs[0].to(dev)
        for x in xs[1:]:
            acc = op(acc, x.to(dev))
        out[dev] = acc
    return [out[d] for d in mesh.devices]


def psum(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """x_0 + x_1 + ... + x_{D-1} on every shard (lax.psum)."""
    return _reduce(mesh, xs, torch.add)


def pmin(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise minimum over the shards, on every shard (lax.pmin)."""
    return _reduce(mesh, xs, torch.minimum)


def all_gather(mesh: Mesh, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The shards' blocks concatenated along axis 0, on every shard
    (lax.all_gather with tiled=True)."""
    out = {dev: torch.cat([x.to(dev) for x in xs]) for dev in mesh.distinct()}
    return [out[d] for d in mesh.devices]


def replicate(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """A copy of x on every shard's device (one per distinct device)."""
    out = {dev: x.to(dev) for dev in mesh.distinct()}
    return [out[d] for d in mesh.devices]


def bcast_chunk(blocks: Sequence[torch.Tensor], ids: Sequence[int], kl: int,
                dest: torch.device) -> torch.Tensor:
    """Rows `ids` (global, ascending) of a keyframe-axis-sharded array, whose
    shard i holds the rows [i kl, (i+1) kl), assembled on `dest` from their
    owners (streamed.py `_bcast_chunk`; a chunk may span several owners)."""
    parts, run = [], [ids[0]]
    for j in ids[1:]:
        if j // kl == run[0] // kl:
            run.append(j)
        else:
            parts.append(run)
            run = [j]
    parts.append(run)
    out = []
    for run in parts:
        owner = run[0] // kl
        src = blocks[owner]
        out.append(src[index_of([j - owner * kl for j in run], src.device)].to(dest))
    return out[0] if len(out) == 1 else torch.cat(out)


def bcast_kf(blocks: Sequence[torch.Tensor], k: int, kl: int,
             dest: torch.device) -> torch.Tensor:
    """Keyframe k's row of a keyframe-axis-sharded array on `dest`
    (streamed.py `_bcast_kf`)."""
    return bcast_chunk(blocks, [k], kl, dest)[0]


# ---------------------------------------------------------------------------
# The surfel map over the mesh
# ---------------------------------------------------------------------------


class ShardedMap(NamedTuple):
    """The surfel rows [0, rows) in D row blocks (see the module docstring)."""

    shards: tuple   # SurfelMap per shard, each with the global count
    rows: int       # global rows that exist; rows past it are padding

    @property
    def block(self) -> int:
        return self.shards[0].capacity


def split_rows(smap: SurfelMap, nl: int, i: int) -> SurfelMap:
    """Block i (rows [i nl, (i+1) nl)) of a map, padded with invalid rows
    past its end; a view where nothing is padded."""
    rows = smap.capacity
    lo, hi = min(i * nl, rows), min((i + 1) * nl, rows)
    part = smap._replace(**{f: getattr(smap, f)[lo:hi] for f in sf._ROW_FIELDS})
    if hi - lo < nl:
        pad = sf.empty_map(nl - (hi - lo), smap.pos.device)
        part = part._replace(**{f: torch.cat([getattr(part, f), getattr(pad, f)])
                                for f in sf._ROW_FIELDS})
    return part


def shard_rows(mesh: Mesh, smap: SurfelMap) -> ShardedMap:
    """Split a map's rows over the mesh; a block on the map's own device is
    a view, elsewhere a copy."""
    nl = -(-smap.capacity // mesh.size)
    return ShardedMap(tuple(SurfelMap(*(x.to(dev) for x in split_rows(smap, nl, i)))
                            for i, dev in enumerate(mesh.devices)), smap.capacity)


def gather_rows(mesh: Mesh, smap: ShardedMap, device=None) -> SurfelMap:
    """The rows [0, rows) as one map on `device` (default: the primary)."""
    dev = torch.device(device) if device is not None else mesh.primary
    fields = {f: torch.cat([getattr(s, f).to(dev) for s in smap.shards])[:smap.rows]
              for f in sf._ROW_FIELDS}
    return SurfelMap(count=smap.shards[0].count.to(dev), **fields)


def gathered_maps(mesh: Mesh, smap: ShardedMap) -> List[SurfelMap]:
    """The whole map (rows [0, rows)) on every shard's device: an
    all-gather of each field."""
    fields = {f: all_gather(mesh, [getattr(s, f) for s in smap.shards])
              for f in sf._ROW_FIELDS}
    return [SurfelMap(count=s.count, **{f: fields[f][i][:smap.rows] for f in fields})
            for i, s in enumerate(smap.shards)]


# ---------------------------------------------------------------------------
# Keyframe planes over the mesh
# ---------------------------------------------------------------------------


class Planes:
    """The keyframe planes of a K-slot store over a mesh, replicated or
    streamed (K % D == 0). Slots belong to shard slot // kl either way, kl
    being ceil(K / D): in the streamed layout that is where they live; in
    both it is the shard that counts a slot where a stage splits keyframes
    (creation's observation filter, pose optimization). Blocks on the
    store's device are views of its tensors; others are copies, brought up
    to date by `refresh`."""

    def __init__(self, mesh: Mesh, store: Dict[str, torch.Tensor], streamed: bool):
        self.mesh = mesh
        self.streamed = streamed
        self.capacity = store["depth"].shape[0]
        d = mesh.size
        if streamed and self.capacity % d:
            raise ValueError(f"streamed planes: {self.capacity} keyframe slots do "
                             f"not divide over {d} shards")
        self.kl = -(-self.capacity // d)
        self._store = store
        self.blocks: Dict[str, List[torch.Tensor]] = {}
        for name, src in store.items():
            if streamed:
                self.blocks[name] = [src[i * self.kl:(i + 1) * self.kl].to(dev)
                                     for i, dev in enumerate(mesh.devices)]
            else:
                self.blocks[name] = replicate(mesh, src)

    @classmethod
    def of_store(cls, mesh: Mesh, ks, streamed: bool) -> "Planes":
        return cls(mesh, {n: getattr(ks, n) for n in PLANE_NAMES}, streamed)

    def built_from(self, ks, streamed: bool) -> bool:
        """Whether these are the planes of store `ks` as it is now (the
        same tensors: a grown store has new ones) in this layout."""
        return (self.streamed == streamed
                and all(self._store[n] is getattr(ks, n) for n in self._store))

    def owned(self, shard: int):
        """The slots [lo, hi) shard `shard` counts."""
        lo = min(shard * self.kl, self.capacity)
        return lo, min(lo + self.kl, self.capacity)

    def refresh(self, slots: Sequence[int]) -> None:
        """Copy the store's rows `slots` into the blocks that are copies."""
        slots = sorted(slots)
        if not slots:
            return
        for name, src in self._store.items():
            done = set()
            for i, blk in enumerate(self.blocks[name]):
                lo = i * self.kl if self.streamed else 0
                if blk.device == src.device or id(blk) in done:
                    continue  # a view of the store, or a copy already updated
                done.add(id(blk))
                mine = [s for s in slots if lo <= s < lo + blk.shape[0]]
                if mine:
                    idx = torch.tensor(mine, device=src.device)
                    blk[idx.to(blk.device) - lo] = src[idx].to(blk.device)

    def take(self, shard: int, name: str, ids: Sequence[int]) -> torch.Tensor:
        """Plane `name` of the slots `ids` (ascending) on shard `shard`'s
        device: a local read, or the broadcast from their owners."""
        dev = self.mesh.devices[shard]
        blocks = self.blocks[name]
        if self.streamed:
            return bcast_chunk(blocks, ids, self.kl, dev)
        return blocks[shard][index_of(list(ids), dev)]

    def take_kf(self, shard: int, name: str, k: int) -> torch.Tensor:
        """Plane `name` of keyframe k on shard `shard`'s device."""
        dev = self.mesh.devices[shard]
        if self.streamed:
            return bcast_kf(self.blocks[name], k, self.kl, dev)
        return self.blocks[name][shard][k]

    def batch(self, shard: int, ids: Sequence[int], q, t, names=PLANE_NAMES[:5],
              mask=None) -> KeyframeStack:
        """A KeyframeStack of the slots `ids` on shard `shard` (planes not in
        `names` are None; q and t are the shard's [K] replicas)."""
        dev = self.mesh.devices[shard]
        idx = index_of(list(ids), dev)
        planes = [self.take(shard, n, ids) if n in names else None
                  for n in PLANE_NAMES[:5]]
        return KeyframeStack(*planes, q[idx], t[idx],
                             None if mask is None else mask[idx])

    def local_stack(self, shard: int, q, t, mask, k: int) -> KeyframeStack:
        """The slots [lo, min(hi, k)) that shard `shard` owns, as a stack of
        its own planes (a local read in both layouts)."""
        lo, hi = self.owned(shard)
        hi = min(hi, k)
        off = lo if self.streamed else 0
        planes = [self.blocks[n][shard][lo - off:hi - off] for n in PLANE_NAMES[:5]]
        return KeyframeStack(*planes, q[lo:hi], t[lo:hi], mask[lo:hi])

    def nbytes(self, shard: int) -> int:
        """Bytes of the plane tensors shard `shard` holds."""
        return sum(blocks[shard].nbytes for blocks in self.blocks.values())

    def keyframes_held(self, shard: int) -> int:
        return self.blocks["depth"][shard].shape[0]
