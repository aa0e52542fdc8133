"""Device meshes and the split of a fleet's planes over them.

Counterpart of what ``jax.sharding.Mesh`` and ``jax.shard_map`` give the JAX
package: a named grid of devices, and the scatter / gather between one
array and its per-device shards.  PyTorch runs one controller over every
device it sees, so a mesh here is an array of ``torch.device``s and a
sharded array is a nested list of tensors, one per cell, each on its cell's
device.  The step functions of ``grid2d.py`` and ``rowsharded.py`` loop over
the cells; a collective (``ppermute``, ``psum``, ``pmax``) is a copy or a
reduction between the cells' tensors.

PyTorch has no virtual devices: where the JAX package's tests split one
host into 8 devices, a mesh here may name the SAME device in several cells.
Each cell still sees only its own tensors, so the code path is the one a
mesh over several cards takes (not yet run on more than one); the cells of
one device just run one after the other.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class Mesh:
    """A named grid of devices: ``Mesh(devices, ("stream", "rows"))``,
    ``Mesh(devices, ("stream",))`` or ``Mesh(devices, ("rows",))``.
    ``devices`` is an array (or nested sequence) of ``torch.device``s or
    device strings with one dimension per axis name."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [torch.device(d) for d in np.asarray(devices,
                                                    dtype=object).ravel()]
        shape = np.shape(np.asarray(devices, dtype=object))
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh devices have {len(shape)} dimensions, "
                             f"axis names {self.axis_names}")
        self.devices = np.empty(len(flat), dtype=object)
        self.devices[:] = flat
        self.devices = self.devices.reshape(shape)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def grid(self) -> np.ndarray:
        """The devices as a (stream, rows) array, a missing axis of size
        1."""
        s = self.shape.get("stream", 1)
        return self.devices.reshape(s, self.shape.get("rows", 1))

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def visible_devices() -> List[torch.device]:
    """The cards this process sees."""
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


class Layout:
    """How a fleet's row-stacked planes (..., S*Hp, Wp) -- stream ``si`` in
    rows [si*Hp, (si+1)*Hp) -- split over a (stream, rows) mesh: cell
    (i, j) holds rows [j*Hs, (j+1)*Hs) of streams [i*S_l, (i+1)*S_l),
    row-stacked again as (..., S_l*Hs, Wp), on its own device."""

    def __init__(self, mesh: Optional[Mesh], s: int, hp: int, wp: int,
                 device=None):
        if mesh is None:
            mesh = Mesh([torch.device(device)], ("stream",))
        self.mesh = mesh
        self.devices = mesh.grid()
        self.s_ax, self.r_ax = self.devices.shape
        if s % self.s_ax:
            raise ValueError(f"n_streams={s} must be a multiple of the "
                             f"stream axis size {self.s_ax}")
        if hp % self.r_ax:
            raise ValueError(f"rows axis {self.r_ax} must divide the padded "
                             f"height {hp}")
        self.s, self.hp, self.wp = s, hp, wp
        self.s_l, self.hs = s // self.s_ax, hp // self.r_ax

    @property
    def whole(self) -> bool:
        """One cell holds everything."""
        return self.s_ax == 1 and self.r_ax == 1

    def cells(self):
        return [(i, j) for i in range(self.s_ax) for j in range(self.r_ax)]

    def streams(self, i: int) -> slice:
        """The streams of stream shard ``i``."""
        return slice(i * self.s_l, (i + 1) * self.s_l)

    def _cell_view(self, x: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """Cell (i, j)'s part of a row-stacked tensor, (..., S_l, Hs, Wp)
        (a view)."""
        lead = x.shape[:-2]
        return x.view(*lead, self.s, self.r_ax, self.hs, self.wp)[
            ..., self.streams(i), j, :, :]

    def zeros(self, lead: tuple, dtype) -> list:
        return [[torch.zeros(tuple(lead) + (self.s_l * self.hs, self.wp),
                             dtype=dtype, device=self.devices[i, j])
                 for j in range(self.r_ax)] for i in range(self.s_ax)]

    def scatter(self, x: torch.Tensor, out: Optional[list] = None) -> list:
        """Row-stacked (..., S*Hp, Wp) -> its cells, (..., S_l*Hs, Wp)
        each on its device: into ``out`` when given, else new tensors (a
        single cell on ``x``'s own device is ``x`` itself)."""
        lead = tuple(x.shape[:-2])
        if out is None:
            if self.whole and x.device == self.devices[0, 0]:
                return [[x]]
            out = [[torch.empty(lead + (self.s_l * self.hs, self.wp),
                                dtype=x.dtype, device=self.devices[i, j])
                    for j in range(self.r_ax)] for i in range(self.s_ax)]
        for i, j in self.cells():
            if out[i][j] is not x:
                out[i][j].view(*lead, self.s_l, self.hs, self.wp).copy_(
                    self._cell_view(x, i, j))
        return out

    def gather(self, cells: list, device=None) -> torch.Tensor:
        """The inverse of :meth:`scatter`: a row-stacked tensor on
        ``device`` (a copy, unless a single cell already lies there)."""
        first = cells[0][0]
        lead = tuple(first.shape[:-2])
        device = first.device if device is None else torch.device(device)
        if self.whole and first.device == device:
            return first
        out = torch.empty(lead + (self.s * self.hp, self.wp),
                          dtype=first.dtype, device=device)
        for i, j in self.cells():
            self._cell_view(out, i, j).copy_(
                cells[i][j].view(*lead, self.s_l, self.hs, self.wp))
        return out

    def stream_views(self, cells: list, stream: int) -> list:
        """Stream ``stream``'s row slabs, (..., Hs, Wp) views of its R
        cells, top to bottom."""
        i, k = divmod(stream, self.s_l)
        return [cells[i][j][..., k * self.hs:(k + 1) * self.hs, :]
                for j in range(self.r_ax)]
