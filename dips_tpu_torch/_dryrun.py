"""Multi-cell dry run: every mesh path of the port on N CPU cells.

Counterpart of ``dips_tpu/_dryrun.py``.  ``python -m dips_tpu_torch._dryrun
N`` builds meshes of N cells that all name the CPU (``parallel/mesh.py``:
a cell sees only its own tensors, so this is the code path a mesh over N
cards takes) and runs every multi-cell path on tiny shapes, the kernels'
plain twins in each cell:

  1. the stream axis: ``MultiStreamEngine`` on a stream mesh, ring and
     tail protocols, planar and hwc input; ``MultiHostStreamEngine`` in one
     process, both protocols and a STATS_ONLY raw fleet, over two batches
     so that the carried state crosses a batch;
  2. one stream's rows: ``make_rowsharded_step`` / ``_ring_step``;
  3. the 2-D (stream x rows) grid: ``make_grid_step`` on both backends and
     the ring-carry engine on the grid;
  4. raw (absdiff) modes on the rows mesh and on the grid.

It asks for the CPU by design, as the JAX dry run does: this is not a
fallback from the card.  Prints ``DRYRUN-OK`` and exits 0; any failure
raises (non-zero exit, traceback on stderr).
"""

from __future__ import annotations

import sys


def run(n_devices: int) -> None:
    """The mesh workload on ``n_devices`` CPU cells."""
    import numpy as np
    import torch

    from dips_tpu_torch.parallel import (Mesh, MultiHostStreamEngine,
                                         MultiStreamEngine,
                                         make_rowsharded_ring_step,
                                         make_rowsharded_step, stream_mesh)
    from dips_tpu_torch.parallel.grid2d import grid_mesh, make_grid_step
    from dips_tpu_torch.properties import (DiPsFilter, DiPsProperties,
                                           OutputMode)
    from dips_tpu_torch.ops.reference import pad_geometry

    cpu = ["cpu"] * n_devices
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.SIGMOID)
    h, w = 16, 24
    s = n_devices
    rng = np.random.default_rng(0)
    feeds = [[rng.integers(0, 256, (h, w, 3), np.uint8) for _ in range(2)]
             for _ in range(s)]
    u8 = lambda *shape: torch.from_numpy(
        rng.integers(0, 256, shape, np.uint8))
    zeros = lambda *shape, dtype=torch.float32: torch.zeros(shape,
                                                            dtype=dtype)

    # 1. the stream axis: both protocols, host-planarized and device-side
    # (hwc) input
    mesh = stream_mesh(devices=cpu)
    for ring in (False, True):
        for layout in ("planar", "hwc"):
            eng = MultiStreamEngine(props, h, w, n_streams=s, batch=2,
                                    mesh=mesh, device="cpu",
                                    ring_carry=ring, input_layout=layout)
            out, stats, gmean = eng.process_batch(feeds)
            assert out.shape == (s, 2, h, w, 3), (ring, layout, out.shape)
            assert np.isfinite(stats).all() and np.isfinite(gmean)

    # 1b. the multi-host engine in one process: every stream is local, but
    # the per-process staging and the global-mean reduction are the ones a
    # cluster runs; two batches so the carried state crosses a batch
    for ring in (False, True):
        mh = MultiHostStreamEngine(props, h, w, n_streams=s, batch=2,
                                   mesh=mesh, device="cpu", ring_carry=ring)
        assert mh.local_stream_ids == list(range(s))
        assert mh.ring_carry is ring
        feed = mh.local_frames_template()
        for si in mh.local_stream_ids:
            feed[si] = feeds[si]
        for _ in range(2):
            mout, mstats, mgmean = mh.process_batch(feed)
            assert mout.shape == (s, 2, h, w, 3), mout.shape
            assert np.isfinite(mstats).all() and np.isfinite(mgmean)

    # 1c. the multi-host raw fleet (the events fleet): the raw ring
    # protocol's carried u8 prev / baseline state
    rawp_mh = DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2)
    mhr = MultiHostStreamEngine(rawp_mh, h, w, n_streams=s, batch=2,
                                mesh=mesh, device="cpu", ring_carry=True)
    feed = mhr.local_frames_template()
    for si in mhr.local_stream_ids:
        feed[si] = feeds[si]
    for _ in range(2):
        mout, mstats, mgmean = mhr.process_batch(feed)
        assert mout.shape == (s, 2, h, w, 0), mout.shape
        assert np.isfinite(mstats).all() and np.isfinite(mgmean)

    # 2. one stream's rows over the cells, halo rows from the neighbours
    rows_mesh = Mesh(cpu, ("rows",))
    hh = max(8 * n_devices, 16)  # >= one 8-row slab per cell
    hp, wp = pad_geometry(hh, 24)
    t, b = props.temporal_size, 2
    step = make_rowsharded_step(props, hh, 24, rows_mesh)
    out2, stats2, _, _ = step(u8(t + b, 3, hp, wp), zeros(hp, wp),
                              np.asarray([True, False]), zeros(hp, wp),
                              np.ones((b,), bool))
    assert out2.shape[0] == b and torch.isfinite(stats2).all()

    # 3. the 2-D grid: streams x row slabs, both cell bodies
    s_ax = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    r_ax = n_devices // s_ax
    gmesh = grid_mesh(s_ax, r_ax, devices=cpu)
    gh = 8 * r_ax
    ghp, gwp = pad_geometry(gh, 24)
    graw = u8(s_ax, t + b, 3, ghp, gwp)
    for gbackend in ("plain", "kernel"):
        gstep = make_grid_step(props, gh, 24, gmesh, backend=gbackend)
        gout, gstats, _, _, gscalar = gstep(
            graw, zeros(s_ax, ghp, gwp), np.asarray([[True, False]] * s_ax),
            zeros(s_ax, ghp, gwp), np.ones((s_ax, b), bool))
        assert tuple(gout.shape[:2]) == (s_ax, b)
        assert torch.isfinite(gstats).all() and np.isfinite(float(gscalar))

    # 3b. ring-carry on the grid through the engine, two batches
    geng = MultiStreamEngine(props, gh, 24, n_streams=s_ax, batch=b,
                             mesh=gmesh, device="cpu", ring_carry=True)
    assert geng.ring_carry
    gfeeds = [[rng.integers(0, 256, (gh, 24, 3), np.uint8)
               for _ in range(b)] for _ in range(s_ax)]
    for _ in range(2):
        gout, gstats, ggm = geng.process_batch(gfeeds)
        assert gout.shape == (s_ax, b, gh, 24, 3)
        assert np.isfinite(gstats).all() and np.isfinite(ggm)

    # 3c. ring-carry row-sharded single stream
    rstep = make_rowsharded_ring_step(props, hh, 24, rows_mesh)
    rout, rstats, *_ = rstep(
        u8(b, 3, hp, wp), zeros(t, hp, wp), zeros(hp, wp), zeros(hp, wp),
        np.asarray([True, False]), zeros(hp, wp), np.ones((b,), bool), 0, 1)
    assert rout.shape[0] == b and torch.isfinite(rstats).all()

    # 4. raw (absdiff) modes on the rows mesh: no halo, only the stats
    # cross cells; tail and ring protocols
    rawp = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=t)
    astep = make_rowsharded_step(rawp, hh, 24, rows_mesh, backend="kernel")
    araw = u8(t + b, 3, hp, wp)
    aout, astats, _, _ = astep(
        araw, zeros(3, hp, wp, dtype=torch.uint8), np.asarray([True, False]),
        zeros(hp, wp), np.ones((b,), bool))
    assert aout.shape[0] == b and torch.isfinite(astats).all()
    arstep = make_rowsharded_ring_step(rawp, hh, 24, rows_mesh)
    aout2, astats2, *_ = arstep(
        araw[t:].clone(), zeros(3, hp, wp, dtype=torch.uint8),
        zeros(3, hp, wp, dtype=torch.uint8), np.asarray([True, False]),
        zeros(hp, wp), np.ones((b,), bool), 1)
    assert aout2.shape[0] == b and torch.isfinite(astats2).all()

    # 4b. raw modes on the grid (many huge no-map cameras): the tail
    # bodies on both backends, then ring-carry through the engine
    graw_r = u8(s_ax, t + b, 3, ghp, gwp)
    for gbackend in ("plain", "kernel"):
        grstep = make_grid_step(rawp, gh, 24, gmesh, backend=gbackend)
        gro, grs, _, _, grg = grstep(
            graw_r, zeros(s_ax, 3, ghp, gwp, dtype=torch.uint8),
            np.asarray([[True, False]] * s_ax), zeros(s_ax, ghp, gwp),
            np.ones((s_ax, b), bool))
        assert tuple(gro.shape[:2]) == (s_ax, b)
        assert torch.isfinite(grs).all() and np.isfinite(float(grg))
    rgeng = MultiStreamEngine(rawp, gh, 24, n_streams=s_ax, batch=b,
                              mesh=gmesh, device="cpu", ring_carry=True)
    assert rgeng.ring_carry
    rgfeeds = [[rng.integers(0, 256, (gh, 24, 3), np.uint8)
                for _ in range(b)] for _ in range(s_ax)]
    for _ in range(2):
        rgo, rgs, rgg = rgeng.process_batch(rgfeeds)
        assert rgo.shape == (s_ax, b, gh, 24, 3)
        assert np.isfinite(rgs).all() and np.isfinite(rgg)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    run(int(args[0]) if args else 8)
    print("DRYRUN-OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
