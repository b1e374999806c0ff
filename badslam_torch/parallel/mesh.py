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
run is repeatable; it takes and gives tensors only, so nothing of a
collective reads a value back to the host. Shards may share a device: a
CPU mesh holds its shards on the one CPU device (the counterpart of the 8
virtual CPU devices the JAX tests force), and an explicit device list may
repeat a card.

State over the mesh:
  * ``ShardedMap``: the rows [0, rows) of a map (a BA call's surfel
    bucket, the JAX package's ``P("d")`` over its sliced map) in D
    contiguous blocks of ceil(rows / D) rows, block i on device i; where D
    does not divide the rows, the last block is padded with invalid rows
    (past `rows`, dropped by ``gather_rows``); every block carries the
    global ``count``;
  * ``Planes``: the keyframe planes, replicated (every device holds all
    slots) or streamed (shard i holds the slots [i K/D, (i+1) K/D) of the
    K-slot store). A stage reads the planes of keyframe slots given as an
    int64 index tensor, so no slot list is read back: ``take`` gives every
    shard its copy, an ``index_select`` of its block where the planes are
    replicated, and where they are streamed the masked psum of
    streamed.py:70-100 (``bcast_rows``: each shard contributes the rows it
    owns and zeros elsewhere); ``local`` reads slots a shard holds.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, NamedTuple, Sequence

import torch

from badslam_torch.mapping import surfels as sf
from badslam_torch.mapping.keyframes import KeyframeStack, static_blocks
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


def bcast_rows(mesh: Mesh, blocks: Sequence[torch.Tensor], ids: torch.Tensor,
               kl: int) -> List[torch.Tensor]:
    """Rows `ids` (global slots, an int64 tensor) of a keyframe-axis-sharded
    array whose shard j holds the rows [j kl, (j+1) kl), on every shard
    (streamed.py `_bcast_chunk` / `_bcast_kf`): shard j contributes the rows
    it owns and zeros elsewhere, and a psum assembles them, so a chunk may
    span several owners and no owner is read back. Adding zeros is exact."""
    parts = []
    for j, blk in enumerate(blocks):
        local = ids.to(blk.device)
        rows = blk.index_select(0, local % kl)
        mine = (local // kl == j).reshape((-1,) + (1,) * (blk.ndim - 1))
        parts.append(torch.where(mine, rows, torch.zeros_like(rows)))
    return psum(mesh, parts)


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
    """Split a map's rows (a BA call's surfel bucket) over the mesh in
    blocks of ceil(rows / D), the last padded with invalid rows; a block on
    the map's own device that needs no padding is a view, elsewhere a
    copy."""
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
    streamed (K % D == 0). Where a stage splits a call's keyframes over the
    shards (creation's observation filter, pose optimization), shard i
    counts the rows ``owned(i, k)``. Blocks on the store's
    device are views of its tensors; others are copies, brought up to date
    by `refresh` (on the host, before a BA call)."""

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

    def owned(self, shard: int, k: int = None):
        """The rows [lo, hi) of a call's k keyframes (default: the store's
        slots) that shard `shard` counts: where the planes are streamed the
        slots it holds (a streamed call's rows are the store's slots),
        where they are replicated blocks of ceil(k / D)."""
        k = self.capacity if k is None else k
        kl = self.kl if self.streamed else -(-k // self.mesh.size)
        lo = min(shard * kl, k)
        return lo, min(lo + kl, k)

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

    def take(self, name: str, ids: torch.Tensor) -> List[torch.Tensor]:
        """Plane `name` of the slots `ids` (an int64 tensor) on every shard:
        an index_select of the shard's block (one per device), or the
        broadcast from their owners."""
        blocks = self.blocks[name]
        if self.streamed:
            return bcast_rows(self.mesh, blocks, ids, self.kl)
        out = {}
        for blk in blocks:
            if id(blk) not in out:
                out[id(blk)] = blk.index_select(0, ids.to(blk.device))
        return [out[id(blk)] for blk in blocks]

    def take_kf(self, name: str, k: torch.Tensor) -> List[torch.Tensor]:
        """Plane `name` of the slot `k` (an int64 scalar tensor) on every
        shard."""
        return [x[0] for x in self.take(name, k.reshape(1))]

    def batch(self, ids: torch.Tensor, q, t, mask,
              names=PLANE_NAMES[:5]) -> List[KeyframeStack]:
        """A KeyframeStack of the slots `ids` (an int64 tensor) on every
        shard, with the shards' replicas of the rows of q, t and mask that
        go with them (planes not in `names` are None)."""
        planes = {n: self.take(n, ids) for n in names}
        return [KeyframeStack(*(planes[n][i] if n in planes else None
                                for n in PLANE_NAMES[:5]), q[i], t[i], mask[i])
                for i in range(self.mesh.size)]

    def blocks_of(self, ids: torch.Tensor, q, t, mask, names=PLANE_NAMES[:5]):
        """For each fixed block of KEYFRAME_BATCH rows of a call (`ids` the
        rows' slots; q, t, mask the shards' replicas of the rows): (block,
        every shard's KeyframeStack of its rows with the mask carried)."""
        for s in static_blocks(ids.shape[0]):
            yield s, self.batch(ids[s], [x[s] for x in q], [x[s] for x in t],
                                [x[s] for x in mask], names)

    def local(self, shard: int, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Plane `name` of the slots `ids` that shard `shard` holds, read
        from its own block (no collective)."""
        blk = self.blocks[name][shard]
        ids = ids.to(blk.device)
        return blk.index_select(0, ids - shard * self.kl if self.streamed else ids)

    def local_stack(self, shard: int, ids: torch.Tensor, q, t, mask,
                    names=PLANE_NAMES[:5]) -> KeyframeStack:
        """The slots `ids`, all held by shard `shard`, as a stack of its own
        planes with the rows q, t, mask that go with them."""
        return KeyframeStack(*(self.local(shard, n, ids) if n in names else None
                               for n in PLANE_NAMES[:5]), q, t, mask)

    def nbytes(self, shard: int) -> int:
        """Bytes of the plane tensors shard `shard` holds."""
        return sum(blocks[shard].nbytes for blocks in self.blocks.values())

    def keyframes_held(self, shard: int) -> int:
        return self.blocks["depth"][shard].shape[0]
