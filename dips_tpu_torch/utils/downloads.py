"""A batch's results downloaded into page-locked host memory that the
caller owns.

Both engines bring each batch's maps and stats down through a
:class:`Downloads`.  On a card every tensor is copied, without blocking,
into a new page-locked host tensor from PyTorch's caching host allocator;
the stream is synchronised once for the batch, and the caller gets numpy
views of those tensors.  A pageable destination instead goes through a
CUDA staging buffer into freshly mapped pages, at a small fraction of the
link's rate.

The caller owns what it gets for as long as it keeps it.  Nothing is
handed out twice: a block goes back to the allocator's pool only when the
last array viewing it is dropped, and a later batch then reuses it
without page-locking new memory.  So the pool holds as many blocks as the
caller keeps results alive, plus the batch in flight.  A result smaller
than a page (a batch's stats) comes back as a copy of its own and its
block goes straight back: the run paths keep every batch's stats, and
would otherwise hold a page-locked block a batch for the whole run.

A download is counted only when the caller asks (the engines ask while
their stage timers are on, as under ``--profile``): reading the
allocator's count costs more than the download of a batch's stats.

On the CPU the tensors' own numpy views come back, as ``.cpu().numpy()``
gives them, and nothing is counted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _host_allocs() -> int:
    """Blocks the caching host allocator has page-locked in this process
    (the nested form: the flat ``host_memory_stats()`` costs about four
    times as much a call)."""
    return torch.cuda.memory.host_memory_stats_as_nested_dict()[
        "num_host_alloc"]


#: results under this many bytes are copied out of their page-locked block
_COPY_BELOW = 4096


class Downloads:
    """One engine's downloads on ``device``, with three counts of those
    made on a card with ``count``: ``batches``, ``nbytes`` (bytes brought
    down) and ``new_blocks`` (the batches whose download page-locked a
    new block).
    The allocator is shared by the process: where several engines
    download at once, a block one of them page-locked may be counted by
    another."""

    def __init__(self, device: torch.device):
        self.device = device
        self.batches = 0
        self.nbytes = 0
        self.new_blocks = 0

    @property
    def reuse_share(self) -> Optional[float]:
        """The share of the batches whose download page-locked nothing
        new, ``1 - new_blocks / batches``; None before the first counted
        download on a card."""
        return 1.0 - self.new_blocks / self.batches if self.batches else None

    def fetch(self, *tensors: torch.Tensor, count: bool = False
              ) -> Tuple[np.ndarray, ...]:
        """The tensors as host numpy arrays, in order, once every copy has
        landed; with ``count`` the download is counted."""
        if self.device.type != "cuda":
            return tuple(t.numpy() for t in tensors)
        before = _host_allocs() if count else 0
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for dst, src in zip(host, tensors):
            dst.copy_(src, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        if count:
            self.batches += 1
            self.nbytes += sum(t.nbytes for t in host)
            self.new_blocks += _host_allocs() > before
        return tuple(t.numpy().copy() if t.nbytes < _COPY_BELOW
                     else t.numpy() for t in host)
