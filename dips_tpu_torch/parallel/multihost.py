"""Multi-process stream processing over ``torch.distributed``.

Counterpart of ``dips_tpu/parallel/multihost.py``.  One process per host
(or per card), SPMD: every process builds a ``MultiHostStreamEngine`` with
the same arguments and runs the same batches.  Each process keeps the device
state of ITS streams only, on its own cells, and feeds frames only for
them.  The one thing that crosses processes each batch is the global mean
|diff|: an all-reduce of two numbers (the valid-weighted sum of each
frame's mean |diff| and the valid count), the JAX step's ``psum``.  The
statistics are on the host by then, so the all-reduce runs on gloo over
CPU tensors: no device tensor crosses processes, and several processes may
share one card (NCCL refuses two ranks on one card).

Deployment shape (one command per process)::

    # torchrun sets RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT
    torchrun --nnodes 2 --nproc-per-node 1 --rdzv-endpoint host0:9876 app.py

    # or explicit: the coordinator's host:port, the process count, the rank
    python app.py --coordinator host0:9876 --nprocs 2 --rank $RANK

with ``init_multihost()`` (torchrun) or ``init_multihost(addr, n, rank)``
called before the engine is built, then ``MultiHostStreamEngine`` in place
of ``MultiStreamEngine``.

Lockstep: every process must build its engine and call ``process_batch``
the SAME NUMBER OF TIMES (each call enters the all-reduce; the engine
learns the other processes' cell counts with a collective when it is
built).  Per-round frame counts may differ between processes, and a
process whose cameras all stalled passes an all-empty feed: it still runs
the batch, masked invalid.  Only the process's own cards have run a mesh
so far; several processes on one card show the exchange and the lockstep,
not scaling across cards.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..errors import StreamError
from ..models.pipeline import resolve_device
from ..properties import DiPsProperties
from .mesh import Mesh, visible_devices
from .multistream import MultiStreamEngine, stream_mesh

log = logging.getLogger("dips_tpu_torch.multihost")

__all__ = ["init_multihost", "MultiHostInfo", "MultiHostStreamEngine"]

#: the topology reported by the first init_multihost() of this process
#: (later calls return it: counting the cells again is a collective)
_info: Optional["MultiHostInfo"] = None

#: the torchrun environment: any of these set means a cluster to join
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


@dataclass(frozen=True)
class MultiHostInfo:
    """What this process looks like inside the cluster: its rank, the
    process count, its cells (the cards it sees, or 1 on a host without
    one: the CPU) and the sum of every process's cells."""
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int

    @property
    def is_coordinator(self) -> bool:
        return self.process_index == 0


def _rank_world():
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_counts(n_local: int) -> List[int]:
    """Every process's ``n_local``, in rank order (a collective)."""
    rank, world = _rank_world()
    if world == 1:
        return [n_local]
    counts = [None] * world
    dist.all_gather_object(counts, int(n_local))
    return [int(c) for c in counts]


def init_multihost(coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> MultiHostInfo:
    """Join (or form) a cluster of processes.

    With arguments: the coordinator's ``host:port``, the process count and
    this process's rank (all three), joined over gloo at
    ``tcp://host:port``.  Without: the cluster that torchrun's environment
    describes (``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``env://``); with no such environment, a single
    process.  A cluster that is named but cannot be joined raises: a
    process that went on alone would deadlock its peers in the first
    batch.  Idempotent: a later call returns the same topology."""
    global _info
    explicit = (coordinator_address, num_processes, process_id)
    if _info is not None:
        return _info
    if dist.is_initialized():
        pass  # joined by the caller: report its topology
    elif any(v is not None for v in explicit):
        if any(v is None for v in explicit):
            raise ValueError("init_multihost: pass coordinator_address, "
                             "num_processes and process_id together")
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator_address}",
            world_size=int(num_processes), rank=int(process_id))
    elif any(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group("gloo", init_method="env://")
    else:
        log.info("no cluster configured: single-process topology")
    rank, world = _rank_world()
    n_local = len(visible_devices()) or 1
    _info = MultiHostInfo(process_index=rank, process_count=world,
                          local_device_count=n_local,
                          global_device_count=sum(_all_counts(n_local)))
    return _info


class MultiHostStreamEngine(MultiStreamEngine):
    """``MultiStreamEngine`` over the cells of every process.

    ``n_streams`` is the GLOBAL stream count.  ``mesh`` is THIS process's
    1-D stream mesh (default: ``stream_mesh()`` over its visible cards; on
    ``device="cpu"`` one CPU cell); the engine learns the other processes'
    cell counts once, when it is built.  The global mesh is every process's
    cells in rank order, and cell k holds streams [k*rpd, (k+1)*rpd), rpd =
    ``n_streams`` / the global cell count.  (The JAX engine takes the
    global mesh itself, over ``jax.devices()``; the ownership rule is the
    same.)  Each process:

    * owns the streams of its own cells (:attr:`local_stream_ids`, a
      contiguous block), and keeps device state and host staging for them
      only;
    * passes ``process_batch`` a full ``n_streams``-long list in which only
      ITS streams carry frames (the other entries are ignored: their owners
      feed them);
    * gets back maps and stats for its local streams only (leading axis
      ``len(local_stream_ids)``, in that order) and the global mean |diff|
      over every process's valid frames;
    * checkpoints its own streams (``state_dict`` / ``save`` / ``load``,
      the JAX engine's npz keys: one file per process, restored on the
      process that owns the same streams).

    Both protocols run.  Planar input only (as the JAX engine: no
    ``input_layout`` or ``packed_wire``), and none of the per-stream state
    surgeries (``reset_stream``, ``stream_state_dict``,
    ``load_stream_state``, ``save_stream``, ``load_stream``), which the JAX
    multi-host engine refuses too; ``revive`` and ``snapshot`` work.
    """

    _lockstep_collectives = True  # every process runs every batch

    def __init__(self, props: DiPsProperties, height: int, width: int,
                 n_streams: int, batch: int = 8, mesh: Optional[Mesh] = None,
                 device="cuda", ring_carry: Optional[bool] = None):
        dev = resolve_device(device)
        if mesh is None:
            mesh = stream_mesh() if dev.type == "cuda" \
                else stream_mesh(devices=[dev])
        if "rows" in mesh.axis_names:
            # pods scale by whole streams: a row-sharded frame would have
            # its slabs on other processes, which the host that decodes it
            # cannot feed; row-shard within one process's cells instead
            raise ValueError(
                "MultiHostStreamEngine needs a 1-D stream mesh: a row-"
                "sharded frame would span processes.  Shard streams across "
                "processes here; row-shard within one process via "
                "MultiStreamEngine on a grid mesh.")
        n_local = int(mesh.devices.size)
        counts = _all_counts(n_local)
        n_cells = sum(counts)
        if n_streams % n_cells:
            raise ValueError(
                f"n_streams={n_streams} must be a multiple of the global "
                f"cell count {n_cells}")
        rpd = n_streams // n_cells
        self.process_index, self.process_count = _rank_world()
        first = sum(counts[:self.process_index]) * rpd
        self.local_stream_ids: List[int] = list(
            range(first, first + n_local * rpd))
        self._row_of = {si: k for k, si in enumerate(self.local_stream_ids)}
        super().__init__(props, height, width, n_streams, batch=batch,
                         device=dev, input_layout="planar",
                         ring_carry=ring_carry, mesh=mesh)

    # -- this process's streams ----------------------------------------------
    def _stage_rows(self) -> int:
        return self.n_local_streams

    def _stage_index(self, si: int) -> int:
        return self._row_of.get(si, -1)

    def _stage_gather(self, seq) -> np.ndarray:
        return np.asarray([seq[i] for i in self.local_stream_ids])

    def _global_sums(self, total: torch.Tensor, count: torch.Tensor):
        if not dist.is_initialized():
            return total, count
        sums = torch.stack([total.to(torch.float64),
                            count.to(torch.float64)])
        dist.all_reduce(sums)
        return sums[0], sums[1]

    @property
    def n_local_streams(self) -> int:
        return len(self.local_stream_ids)

    def local_frames_template(self) -> list:
        """A ``process_batch``-shaped list of empty per-stream slots: fill
        the ``local_stream_ids`` entries."""
        return [[] for _ in range(self.n_streams)]

    # -- per-process checkpoints ---------------------------------------------
    def state_dict(self) -> dict:
        """This process's streams: their ids, cursors, baseline (S_l, [3,]
        Hp, Wp), heatmap (S_l, Hp, Wp), planar tails and failures."""
        ids = self.local_stream_ids
        return {
            "local_stream_ids": list(ids),
            "frame_cursors": [self.frame_cursors[i] for i in ids],
            "baseline": self._per_stream(self._baseline),
            "heatmap": self._per_stream(self._heatmap),
            "tails": [self._planar_tail(si) for si in ids],
            "failed": sorted(i for i in self.failed if i in self._row_of),
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore this process's streams from its own checkpoint (in
        lockstep with the other processes, as every batch)."""
        ids = [int(i) for i in state.get("local_stream_ids",
                                         self.local_stream_ids)]
        if ids != self.local_stream_ids:
            raise ValueError(
                f"checkpoint holds streams {ids}, this process owns "
                f"{self.local_stream_ids} (restore each process's own file)")
        n_l, hp, wp = self.n_local_streams, self.hp, self.wp
        bl = np.asarray(state["baseline"])
        expect = (n_l, 3, hp, wp) if self._raw_mode else (n_l, hp, wp)
        if bl.shape != expect:
            raise ValueError(f"checkpoint baseline shape {bl.shape} != "
                             f"local shape {expect}")
        hm = np.asarray(state["heatmap"], np.float32)
        if hm.shape != (n_l, hp, wp):
            raise ValueError(f"checkpoint heatmap shape {hm.shape} != "
                             f"{(n_l, hp, wp)}")
        self._baseline = self._from_per_stream(
            bl.astype(np.uint8 if self._raw_mode else np.float32))
        self._heatmap = self._from_per_stream(hm)
        for i, si in enumerate(ids):
            self.frame_cursors[si] = int(state["frame_cursors"][i])
            self._tails[si] = self._tail_from_checkpoint(
                si, state["tails"][i])
            self._snap_pending[si] = False
        self.failed = {
            int(si): StreamError(int(si),
                                 RuntimeError("restored from checkpoint"))
            for si in state.get("failed", ())}
        self._drop_tails(range(n_l))
        self._rebuild_ring_state()

    def save(self, path: str) -> None:
        """Per-process checkpoint (append the rank to ``path`` when the
        processes share a file system)."""
        s = self.state_dict()
        t = self.props.temporal_size
        tails = np.stack([
            tl if tl is not None
            else np.zeros((t, 3, self.hp, self.wp), np.uint8)
            for tl in s["tails"]])
        has_tail = np.asarray([tl is not None for tl in s["tails"]])
        np.savez_compressed(
            path, local_stream_ids=np.asarray(s["local_stream_ids"]),
            frame_cursors=np.asarray(s["frame_cursors"]),
            baseline=s["baseline"], heatmap=s["heatmap"], tails=tails,
            has_tail=has_tail, failed=np.asarray(s["failed"], np.int64))

    def load(self, path: str) -> None:
        with np.load(path) as z:
            self.load_state_dict({
                "local_stream_ids": z["local_stream_ids"].tolist(),
                "frame_cursors": z["frame_cursors"].tolist(),
                "baseline": z["baseline"],
                "heatmap": z["heatmap"],
                "tails": [z["tails"][i] if z["has_tail"][i] else None
                          for i in range(z["tails"].shape[0])],
                "failed": z["failed"].tolist(),
            })

    # -- refused, as the JAX multi-host engine refuses them ------------------
    def _no_multihost(self, name: str):
        raise NotImplementedError(
            f"{name} is not available on the multi-host engine (the JAX "
            "package's refuses it too); use the per-process checkpoint "
            "(state_dict / save / load) instead")

    def reset_stream(self, stream: int) -> None:
        self._no_multihost("reset_stream")

    def stream_state_dict(self, stream: int) -> dict:
        self._no_multihost("stream_state_dict")

    def load_stream_state(self, stream: int, state: dict) -> None:
        self._no_multihost("load_stream_state")

    def save_stream(self, stream: int, path: str) -> None:
        self._no_multihost("save_stream")

    def load_stream(self, stream: int, path: str) -> None:
        self._no_multihost("load_stream")
