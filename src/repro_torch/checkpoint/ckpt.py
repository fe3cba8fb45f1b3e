"""Checkpoints: a tree of tensors <-> ``path.npz`` + ``path.meta`` (the
port's copy of ``repro/checkpoint/ckpt.py``, in the same format).

``path.npz`` holds one array a leaf under its ``/``-joined key path, the
zip members ``np.savez`` writes (uncompressed ``.npy`` files, each with
its CRC), here written one leaf at a time, each with one write of its
bytes; ``path.meta`` is the msgpack map
``dict(step, keys=sorted(keys), dtypes={key: dtype name}, extra)``
(:mod:`repro_torch.checkpoint._msgpack`, byte for byte what ``msgpack``
writes).  A bfloat16 leaf is stored as float32 with ``"bfloat16"`` in
``dtypes``; the int32 AdamW ``step`` and 2bw's bool ``primed`` keep
their dtypes.  The JAX package reads these files and writes files the
port reads.

Restore is driven by the file's own ``.meta``: each leaf comes back in
its SAVED dtype, not the ``like`` leaf's, on the device the caller
names; ``like`` gives only the structure and the expected shapes.  Keys
or shapes that disagree raise :class:`CheckpointMismatch` naming them.
A tree is nested dicts of tensors, so the reference's NamedTuple and
sequence branches have no counterpart.  Both ways run leaf by leaf, no
more than one leaf held on the host: a leaf leaves the card through one
pinned staging buffer, and a member is read straight into its array
(pieces read by a few threads at once, its CRC checked) from the offset
the zip's directory gives, or only a stage's row of it
(:meth:`CheckpointReader.array`).

On ranks (one share of the tree each, :mod:`repro_torch.launch.mesh`),
:func:`save_rank_shares` writes the whole stacked tree from global rank
0 as its shares arrive, and :func:`restore_rank_share` cuts each rank's
share from the file.
"""
from __future__ import annotations

import concurrent.futures
import os
import struct
import time
import zipfile
import zlib
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import _msgpack


class CheckpointMismatch(ValueError):
    """The checkpoint on disk does not match the requested ``like`` tree
    (missing/unexpected keys or shape disagreement)."""


def _flatten(tree, prefix: str = "") -> dict:
    """``{"/"-joined key path: leaf}`` in sorted-key order at every
    level (the reference's order, which is its ``dtypes`` order)."""
    if not isinstance(tree, dict):
        return {prefix[:-1]: tree}
    out = {}
    for k in sorted(tree):
        out.update(_flatten(tree[k], f"{prefix}{k}/"))
    return out


class CheckpointWriter:
    """Writes ``path.npz`` one leaf at a time (:meth:`write`, in the
    tree's :func:`_flatten` order) and ``path.meta`` at :meth:`close`.
    A leaf on the card comes to the host through one pinned buffer, grown
    to the largest leaf.  ``stats`` counts the bytes stored and the
    seconds spent copying leaves to the host (``copy_s``) and writing
    them (``write_s``, the CRC included)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._zip = zipfile.ZipFile(path + ".npz", mode="w",
                                    compression=zipfile.ZIP_STORED,
                                    allowZip64=True)
        self._pinned = None
        self.dtypes: dict = {}
        self.stats = dict(bytes=0, copy_s=0.0, write_s=0.0)

    def _host(self, leaf) -> tuple:
        """(the numpy array the npz stores, the leaf's dtype name)."""
        if not isinstance(leaf, torch.Tensor):
            a = np.asarray(leaf, order="C")
            return a, str(a.dtype)
        name = str(leaf.dtype).removeprefix("torch.")
        t = leaf.detach()
        if t.dtype == torch.bfloat16:       # no numpy bfloat16
            t = t.float()
        if t.device.type != "cuda":
            return t.contiguous().numpy(), name
        n = t.numel() * t.element_size()
        if self._pinned is None or self._pinned.numel() < n:
            self._pinned = None
            self._pinned = torch.empty(n, dtype=torch.uint8,
                                       pin_memory=True)
        host = self._pinned[:n].view(t.dtype).view(t.shape)
        host.copy_(t)
        return host.numpy(), name

    def write(self, key: str, leaf) -> None:
        t0 = time.perf_counter()
        a, self.dtypes[key] = self._host(leaf)
        t1 = time.perf_counter()
        with self._zip.open(key + ".npy", "w", force_zip64=True) as f:
            np.lib.format.write_array_header_1_0(
                f, np.lib.format.header_data_from_array_1_0(a))
            f.write(a.reshape(-1).view(np.uint8))
        self.stats["copy_s"] += t1 - t0
        self.stats["write_s"] += time.perf_counter() - t1
        self.stats["bytes"] += a.nbytes

    def close(self, step: int = 0, extra: Optional[dict] = None,
              meta: Optional[dict] = None) -> dict:
        """Finish the npz and write the sidecar: ``meta`` as given, or
        the one made from the leaves written, ``step`` and ``extra``."""
        t0 = time.perf_counter()
        self._zip.close()
        if meta is None:
            meta = dict(step=step, keys=sorted(self.dtypes),
                        dtypes=self.dtypes, extra=extra or {})
        with open(self.path + ".meta", "wb") as f:
            f.write(_msgpack.packb(meta))
        self.stats["write_s"] += time.perf_counter() - t0
        self._pinned = None
        return self.stats


def save_checkpoint(path: str, tree: Any, step: int = 0,
                    extra: Optional[dict] = None) -> dict:
    """Write ``tree`` (nested dicts of tensors or numpy arrays) to
    ``path.npz`` + ``path.meta``, one leaf at a time.  ``extra`` is a
    dict of the msgpack subset stored in the sidecar (the layout, say;
    read back with :func:`checkpoint_meta`).  Returns the writer's
    ``stats`` (bytes, ``copy_s``, ``write_s``)."""
    writer = CheckpointWriter(path)
    for key, leaf in _flatten(tree).items():
        writer.write(key, leaf)
    return writer.close(step, extra)


def _load_meta(path: str) -> dict:
    with open(path + ".meta", "rb") as f:
        return _msgpack.unpackb(f.read())


def checkpoint_meta(path: str) -> dict:
    """Full ``.meta`` sidecar: ``step``, ``keys``, ``dtypes``, ``extra``."""
    return _load_meta(path)


def checkpoint_step(path: str) -> int:
    return _load_meta(path)["step"]


#: a member is read in pieces of this many bytes, READERS at a time (one
#: stream of reads does not keep a disk busy)
PIECE, READERS = 64 << 20, 4
#: a zip local file header: signature, 5 shorts, 3 longs, name and extra
#: field lengths
_LOCAL = struct.Struct("<4s5H3L2H")


class CheckpointReader:
    """A checkpoint on disk, read one leaf at a time: ``meta``, ``keys``
    (the npz's, in its order), :meth:`shape` (from the member's ``.npy``
    header), :meth:`array` and :meth:`leaf` (a CPU tensor in the saved
    dtype).  Each member is found from the zip's directory and read into
    its array, in pieces read at once; a whole member's CRC is checked
    unless ``check_crc`` is False.  Members must be stored C-ordered
    arrays, as both packages' ``np.savez`` writes them.  Use it as a context manager."""

    def __init__(self, path: str, check_crc: bool = True):
        self.path, self.check_crc = path, check_crc
        self._pool = None
        self.meta = _load_meta(path)
        self._f = open(path + ".npz", "rb")
        self._members = {}
        with zipfile.ZipFile(self._f) as zf:
            infos = zf.infolist()
        for info in infos:
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}.npz: member {info.filename} is "
                                 f"compressed; a checkpoint's are stored")
            self._f.seek(info.header_offset)
            head = _LOCAL.unpack(self._f.read(_LOCAL.size))
            self._f.seek(info.header_offset + _LOCAL.size + head[-2]
                         + head[-1])
            start = self._f.tell()
            version = np.lib.format.read_magic(self._f)
            read = {(1, 0): np.lib.format.read_array_header_1_0,
                    (2, 0): np.lib.format.read_array_header_2_0}[version]
            shape, fortran, dtype = read(self._f)
            if fortran or dtype.hasobject:
                raise ValueError(f"{path}.npz: member {info.filename} is "
                                 f"not a C-ordered array of numbers")
            self._members[info.filename.removesuffix(".npy")] = (
                start, self._f.tell(), tuple(shape), dtype, info.CRC)
        self.keys = list(self._members)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._pool is not None:
            self._pool.shutdown()
        self._f.close()

    def shape(self, key: str) -> tuple:
        return self._members[key][2]

    def _pread(self, buf: np.ndarray, at: int) -> None:
        """Fill ``buf`` (uint8) from the file at offset ``at``."""
        got = 0
        while got < buf.size:
            n = os.preadv(self._f.fileno(), [memoryview(buf[got:])],
                          at + got)
            if not n:
                raise ValueError(f"{self.path}.npz ends inside a member")
            got += n

    def _read(self, at: int, a: np.ndarray, crc=None) -> Optional[int]:
        """Fill ``a`` from the file at ``at``: pieces of :data:`PIECE`
        bytes read by :data:`READERS` threads at once, the CRC (chained
        from ``crc``, if given) taken over each piece in order as it
        lands.  Returns the CRC."""
        buf = a.reshape(-1).view(np.uint8)
        cuts = range(0, buf.size, PIECE)
        if self._pool is None and len(cuts) > 1:
            self._pool = concurrent.futures.ThreadPoolExecutor(READERS)
        if len(cuts) <= 1:
            self._pread(buf, at)
            return None if crc is None else zlib.crc32(buf, crc)
        done = [self._pool.submit(self._pread, buf[i:i + PIECE], at + i)
                for i in cuts]
        for i, piece in zip(cuts, done):
            piece.result()
            if crc is not None:
                crc = zlib.crc32(buf[i:i + PIECE], crc)
        return crc

    def array(self, key: str, row: Optional[int] = None) -> np.ndarray:
        """The stored array (a bfloat16 leaf as float32), or only its
        ``row`` along the leading axis (read alone; no CRC check)."""
        start, at, shape, dtype, crc = self._members[key]
        if row is not None:
            a = np.empty(shape[1:], dtype)
            self._read(at + row * a.nbytes, a)
            return a
        a = np.empty(shape, dtype)
        if not self.check_crc:
            self._read(at, a)
            return a
        head = np.empty(at - start, np.uint8)
        self._pread(head, start)
        if self._read(at, a, zlib.crc32(head)) != crc:
            raise ValueError(f"{self.path}.npz: member {key} fails its CRC")
        return a

    def leaf(self, key: str, row: Optional[int] = None) -> torch.Tensor:
        """:meth:`array` as a CPU tensor in the saved dtype."""
        a = self.array(key, row)
        dt = self.meta.get("dtypes", {}).get(key, str(a.dtype))
        if dt == "bfloat16":
            return torch.from_numpy(a).to(torch.bfloat16)
        if str(a.dtype) != dt:
            a = a.astype(dt)
        return torch.from_numpy(a)

    def check(self, want: dict, saved_keys=None) -> None:
        """Raise :class:`CheckpointMismatch` unless the file holds
        exactly the keys of ``want`` (``{key: expected shape}``; or, with
        ``saved_keys``, those keys and ``want``'s keys are a subset of
        them) with those shapes, naming each key that differs."""
        like_keys = set(saved_keys if saved_keys is not None else want)
        saved = set(self.keys)
        if saved != like_keys:
            missing = sorted(like_keys - saved)
            unexpected = sorted(saved - like_keys)
            raise CheckpointMismatch(
                f"checkpoint {self.path!r} does not match the requested "
                f"tree: "
                + (f"missing keys {missing}" if missing else "")
                + (" ; " if missing and unexpected else "")
                + (f"unexpected keys {unexpected}" if unexpected else ""))
        bad = [f"{k}: saved {self.shape(k)} != expected {tuple(want[k])}"
               for k in sorted(want) if self.shape(k) != tuple(want[k])]
        if bad:
            raise CheckpointMismatch(
                f"checkpoint {self.path!r} shape mismatch (reshard it "
                f"first? see repro_torch.checkpoint.reshard): "
                + " ; ".join(bad))


def _rebuild(tree, prefix: str, leaf) -> Any:
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], f"{prefix}{k}/", leaf) for k in tree}
    return leaf(prefix[:-1])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(host, device: torch.device,
               stats: Optional[dict]) -> torch.Tensor:
    """``host()`` (a CPU tensor) on ``device``, the seconds spent reading
    and copying added to ``stats``."""
    t0 = time.perf_counter()
    t = host()
    t1 = time.perf_counter()
    out = t.to(device)
    _sync(device)
    if stats is not None:
        stats["bytes"] = (stats.get("bytes", 0)
                          + out.numel() * out.element_size())
        stats["read_s"] = stats.get("read_s", 0.0) + t1 - t0
        stats["copy_s"] = stats.get("copy_s", 0.0) + time.perf_counter() - t1
    return out


def restore_checkpoint(path: str, like: Any, device="cuda",
                       stats: Optional[dict] = None) -> Any:
    """Rebuild the tree saved at ``path`` into the structure of ``like``
    (nested dicts whose leaves have a ``shape``), each leaf in its saved
    dtype on ``device`` (the card unless the caller asks for the CPU),
    read and copied one at a time.  ``stats``, if given, gets the bytes
    restored and the seconds spent reading (``read_s``) and copying to
    the device (``copy_s``)."""
    device = torch.device(device)
    with CheckpointReader(path) as ck:
        ck.check({k: tuple(v.shape) for k, v in _flatten(like).items()})
        return _rebuild(like, "", lambda key: _to_device(
            lambda: ck.leaf(key), device, stats))


def save_rank_shares(path: str, share: dict, mesh, cfg, plan,
                     step: int = 0, extra: Optional[dict] = None):
    """:func:`save_checkpoint` of the whole stacked tree, on ranks: every
    rank calls this with its share (:func:`repro_torch.pipeline.stage.
    cut_leaf` of the tree; parameters, moments, 2bw's ``pending``, the
    scalars every rank holds).  Replica 0's ranks send their shares to
    global rank 0 one leaf at a time
    (:func:`repro_torch.launch.mesh.gather_leaves`); rank 0 joins each
    leaf (``stage.join_leaf``) and writes it before the next arrives, so
    no rank holds more than one leaf of another's.  One barrier after
    the write.  Returns the writer's stats on rank 0, else None."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.pipeline import stage as ST
    writer = CheckpointWriter(path) if mesh.rank == 0 else None
    t0 = time.perf_counter()
    for p, pieces in MESH.gather_leaves(
            share, mesh, lambda p: ST.share_holders(p, cfg, plan)):
        writer.write("/".join(p), ST.join_leaf(p, pieces, cfg, plan))
    stats = None
    if writer is not None:
        stats = writer.close(step, extra)
        stats["total_s"] = time.perf_counter() - t0
    dist.barrier()
    return stats


def restore_rank_share(path: str, like: dict, mesh, cfg, plan, device="cuda",
                       stats: Optional[dict] = None) -> dict:
    """:func:`restore_checkpoint` of this rank's share (``like``: its
    share's structure and shapes) from the whole stacked tree at
    ``path``: of a ``layers`` leaf only its stage's row is read, of any
    other leaf the whole; each is cut to its tensor shard
    (``stage.cut_leaf``) and moved to ``device`` before the next is
    read.  The file must hold exactly the keys of one replica's shares
    (gathered from every rank) with the shapes they join to."""
    from repro_torch.launch import mesh as MESH
    from repro_torch.pipeline import stage as ST
    device = torch.device(device)
    flat = _flatten(like)
    every = MESH.gather(sorted(flat), mesh)

    def share(ck, key):
        p = tuple(key.split("/"))
        top = ST.param_path(p)
        if top is not None and top[0] == "layers":
            return ST.cut_leaf(p, ck.leaf(key, row=mesh.stage), cfg, plan,
                               mesh.stage, mesh.tensor_rank, stacked=False)
        return ST.cut_leaf(p, ck.leaf(key), cfg, plan, mesh.stage,
                           mesh.tensor_rank)

    with CheckpointReader(path) as ck:
        ck.check({k: ST.joined_shape(tuple(k.split("/")), v.shape, cfg, plan)
                  for k, v in flat.items()},
                 saved_keys={k for ks in every for k in ks})
        return _rebuild(like, "", lambda key: _to_device(
            lambda: share(ck, key), device, stats))
