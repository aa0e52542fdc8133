"""The port's row-slab path against the JAX package on the CPU.

* ``parallel.grid2d.make_grid_step`` / ``make_grid_ring_step`` and
  ``parallel.rowsharded.make_rowsharded_step`` / ``make_rowsharded_ring_step``
  on a (2, 4) grid / a 4-cell rows mesh of CPU devices (the kernels' plain
  twins) against the JAX functions on ``grid_mesh(2, 4)`` / 4 host devices
  (Pallas in interpret mode, or the portable XLA body against
  ``backend="plain"``, the plain twins on slabs of any height): "bands" and
  "extended", median and raw modes, with and without an roi, two carried
  batches.
* The port's grid against its own full-height stacked step, on 8-row
  slabs and, through the plain backend, on 6-row slabs.
* ``MultiStreamEngine(mesh=grid)`` against the JAX fleet on ``grid_mesh(2,
  4)`` and against the port's fleet without a mesh; checkpoints saved on a
  grid and loaded without one, in both packages, and back; the guards.
* The CLI's ``--mesh SxR``.

Inputs are made with numpy from a seed: 32 x 40 frames (Hp = 32, Wp = 128:
8-row slabs on 4 row shards), 4 streams, B = 4.  Tolerances: u8 maps and
carried state byte-equal on the true H x W region (with an emphasis filter
the maps against the JAX package within 1 LSB; the padding columns differ
by design); stats atol 1e-6 with counts and maxima exact (rtol 1e-5 for the
plain backend against the XLA body, which sums in another order); heatmap
atol 1e-4.
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import dips_tpu_torch.cli
from dips_tpu.parallel import MultiStreamEngine as JaxFleet
from dips_tpu.parallel import grid2d as jgrid
from dips_tpu.parallel import rowsharded as jrows
from dips_tpu.properties import (DiPsFilter, DiPsMethod, DiPsProperties,
                                 OutputMode)
from dips_tpu_torch import MultiStreamEngine as TorchFleet
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops import cuda_fused
from dips_tpu_torch.ops import reference as tref
from dips_tpu_torch.parallel import Mesh, grid2d, grid_mesh, rowsharded, \
    stream_mesh
from tests.conftest import make_clip

torch.set_num_threads(1)

H, W, S, B = 32, 40, 4, 4
HP, WP = tref.pad_geometry(H, W)
RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD, OutputMode.STATS_ONLY)
NOFILT = dict(filter=DiPsFilter.UNFILTERED)


def cpu_grid(s=2, r=4):
    return grid_mesh(s, r, devices=["cpu"] * (s * r))


def is_raw(props):
    return props.output in RAW


def pid(props):
    mode = ("approx" if props.approx_median
            else "quirk" if props.quirk_compat else "exact")
    return (f"{props.output.name}-{props.method.name}-w{props.window_size}"
            f"-{mode}" + ("-roi" if props.roi else ""))


def frames(n, s, seed, h=H):
    """(s, n, 3, Hp, Wp) u8: random bytes on the true region."""
    hp = tref.pad_geometry(h, W)[0]
    r = np.random.default_rng(seed)
    x = np.zeros((s, n, 3, hp, WP), np.uint8)
    x[..., :h, :W] = r.integers(0, 256, (s, n, 3, h, W), np.uint8)
    return x


def zero_state(props, s, ring, xp, h=H):
    """Stream-leading zero state: [ring,] [prev,] baseline, heatmap."""
    hp = tref.pad_geometry(h, W)[0]
    plane = (s, hp, WP)
    if is_raw(props):
        shapes = [((s, 3, hp, WP), np.uint8)] * (2 if ring else 1)
    else:
        shapes = ([((s, props.temporal_size, hp, WP), np.float32),
                   (plane, np.float32)] if ring else []) + [
            (plane, np.float32)]
    shapes.append((plane, np.float32))
    if xp == "jax":
        return [jnp.zeros(sh, dt) for sh, dt in shapes]
    return [torch.from_numpy(np.zeros(sh, dt)) for sh, dt in shapes]


def flags_valid(s, bi):
    flags = np.zeros((s, B), bool)
    flags[:, bi] = True
    flags[0, 2] = True
    valid = np.ones((s, B), bool)
    valid[s - 1, 3] = bi == 0
    return flags, valid


def assert_maps(props, got, exp, h=H, lsb=None):
    g = np.asarray(got)[..., :h, :W].astype(np.int16)
    e = np.asarray(exp)[..., :h, :W].astype(np.int16)
    assert g.shape == e.shape
    if lsb is None:
        lsb = 0 if (is_raw(props)
                    or props.filter == DiPsFilter.UNFILTERED) else 1
    assert np.abs(g - e).max(initial=0) <= lsb


def assert_stats(got, exp, rtol=0.0):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got[..., 2:], exp[..., 2:])
    np.testing.assert_allclose(got[..., :2], exp[..., :2], rtol=rtol,
                               atol=1e-6)


def assert_state(got, exp, h=H):
    """[..., baseline, heatmap]: exact on the true region but for the
    heatmap (atol 1e-4)."""
    for g, e in zip(got[:-1], exp[:-1]):
        np.testing.assert_array_equal(np.asarray(g)[..., :h, :W],
                                      np.asarray(e)[..., :h, :W])
    np.testing.assert_allclose(np.asarray(got[-1]), np.asarray(exp[-1]),
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the grid steps against the JAX package
# ---------------------------------------------------------------------------

RING_CASES = [
    (DiPsProperties(window_size=3, temporal_size=2, **NOFILT), "bands"),
    (DiPsProperties(window_size=5, temporal_size=3, **NOFILT,
                    method=DiPsMethod.PER_FRAME), "bands"),
    (DiPsProperties(window_size=5, temporal_size=2, **NOFILT,
                    roi=(10, 4, 30, 36)), "extended"),
    (DiPsProperties(window_size=7, temporal_size=2, approx_median=True,
                    method=DiPsMethod.PER_FRAME, roi=(10, 4, 30, 36),
                    **NOFILT), "bands"),
    (DiPsProperties(window_size=5, temporal_size=2, quirk_compat=True,
                    **NOFILT), "extended"),
    (DiPsProperties(window_size=1, temporal_size=2), "bands"),
    (DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    roi=(10, 4, 30, 36)), "bands"),
    (DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2,
                    method=DiPsMethod.PER_FRAME), "bands"),
    # every row shard but one misses the roi
    (DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2,
                    method=DiPsMethod.PER_FRAME, roi=(9, 2, 15, 30)),
     "bands"),
]


@pytest.mark.parametrize("props,impl", RING_CASES,
                         ids=[f"{pid(p)}-{i}" for p, i in RING_CASES])
def test_grid_ring_step_matches_jax(props, impl):
    pp = props_from_jax(props)
    t = props.temporal_size
    jstep = jgrid.make_grid_ring_step(props, H, W, jgrid.grid_mesh(2, 4),
                                      slab_impl=impl)
    tstep = grid2d.make_grid_ring_step(pp, H, W, cpu_grid(), slab_impl=impl)
    js, ts = zero_state(props, S, True, "jax"), \
        zero_state(props, S, True, "torch")
    offs, seeds = np.arange(S, dtype=np.int32) % t, np.ones(S, np.int32)
    for bi in range(2):
        raw = frames(B, S, 3 + bi)
        flags, valid = flags_valid(S, bi)
        jargs = (jnp.asarray(flags), js[-1], jnp.asarray(valid))
        targs = (flags, ts[-1], valid)
        if is_raw(props):
            jo = jstep(jnp.asarray(raw), *js[:-1], *jargs,
                       jnp.asarray(seeds))
            to = tstep(torch.from_numpy(raw), *ts[:-1], *targs, seeds)
        else:
            jo = jstep(jnp.asarray(raw), *js[:-1], *jargs,
                       jnp.asarray(offs), jnp.asarray(seeds))
            to = tstep(torch.from_numpy(raw), *ts[:-1], *targs, offs, seeds)
        js = list(jo[2:-1])
        assert all(a is b for a, b in zip(to[2:-1], ts))  # in place
        assert_maps(props, to[0], jo[0])
        assert_stats(to[1], jo[1])
        assert_state(ts, js)
        assert abs(float(to[-1]) - float(jo[-1])) <= 1e-6
        offs = (offs + B) % t
        seeds = np.zeros(S, np.int32)


STEP_CASES = [
    (DiPsProperties(window_size=3, temporal_size=2, **NOFILT), "kernel",
     "bands", H),
    (DiPsProperties(window_size=5, temporal_size=2, **NOFILT,
                    method=DiPsMethod.PER_FRAME, roi=(10, 4, 30, 36)),
     "kernel", "extended", H),
    (DiPsProperties(window_size=3, temporal_size=2), "kernel", "bands", H),
    (DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    roi=(10, 4, 30, 36)), "kernel", "bands", H),
    (DiPsProperties(window_size=3, temporal_size=2, **NOFILT,
                    roi=(10, 4, 30, 36)), "plain", "bands", H),
    (DiPsProperties(window_size=5, temporal_size=2, quirk_compat=True,
                    method=DiPsMethod.PER_FRAME, **NOFILT), "plain",
     "bands", H),
    (DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2,
                    method=DiPsMethod.PER_FRAME, roi=(10, 4, 30, 36)),
     "plain", "bands", H),
    # 6-row slabs: only the plain backend takes them
    (DiPsProperties(window_size=7, temporal_size=2, approx_median=True,
                    **NOFILT), "plain", "bands", 24),
]


@pytest.mark.parametrize(
    "props,backend,impl,h", STEP_CASES,
    ids=[f"{pid(p)}-{b}-{i}-h{h}" for p, b, i, h in STEP_CASES])
def test_grid_step_matches_jax(props, backend, impl, h):
    """The tail-protocol grid step: the slab kernels against Pallas, the
    plain backend against the JAX package's XLA body."""
    pp = props_from_jax(props)
    t = props.temporal_size
    jstep = jgrid.make_grid_step(
        props, h, W, jgrid.grid_mesh(2, 4),
        backend={"kernel": "pallas", "plain": "xla"}[backend],
        slab_impl=impl)
    tstep = grid2d.make_grid_step(pp, h, W, cpu_grid(), backend=backend,
                                  slab_impl=impl)
    js, ts = zero_state(props, S, False, "jax", h), \
        zero_state(props, S, False, "torch", h)
    for bi in range(2):
        raw = frames(t + B, S, 13 + bi, h)
        flags, valid = flags_valid(S, bi)
        jo = jstep(jnp.asarray(raw), js[0], jnp.asarray(flags), js[1],
                   jnp.asarray(valid))
        to = tstep(torch.from_numpy(raw), ts[0], flags, ts[1], valid)
        js = list(jo[2:4])
        assert to[2] is ts[0] and to[3] is ts[1]
        assert_maps(props, to[0], jo[0], h)
        assert_stats(to[1], jo[1], rtol=1e-5 if backend == "plain" else 0.0)
        assert_state(ts, js, h)
        assert abs(float(to[4]) - float(jo[4])) <= 1e-6


ROW_CASES = [
    (DiPsProperties(window_size=5, temporal_size=2, **NOFILT,
                    method=DiPsMethod.PER_FRAME), True, "bands"),
    (DiPsProperties(window_size=3, temporal_size=2, **NOFILT,
                    roi=(10, 4, 30, 36)), True, "extended"),
    (DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    method=DiPsMethod.PER_FRAME, roi=(10, 4, 30, 36)), True,
     "bands"),
    (DiPsProperties(window_size=3, temporal_size=2, **NOFILT), False,
     "bands"),
    (DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    roi=(10, 4, 30, 36)), False, "bands"),
]


@pytest.mark.parametrize("props,ring,impl", ROW_CASES,
                         ids=[f"{pid(p)}-{'ring' if r else 'tail'}-{i}"
                              for p, r, i in ROW_CASES])
def test_rowsharded_steps_match_jax(props, ring, impl):
    """One stream split over 4 row cells, slab kernels, two batches."""
    pp = props_from_jax(props)
    t = props.temporal_size
    jmesh = JaxMesh(np.asarray(jax.devices()[:4]), ("rows",))
    tmesh = Mesh(["cpu"] * 4, ("rows",))
    if ring:
        jstep = jrows.make_rowsharded_ring_step(props, H, W, jmesh,
                                                slab_impl=impl)
        tstep = rowsharded.make_rowsharded_ring_step(pp, H, W, tmesh,
                                                     slab_impl=impl)
    else:
        jstep = jrows.make_rowsharded_step(props, H, W, jmesh,
                                           backend="pallas", slab_impl=impl)
        tstep = rowsharded.make_rowsharded_step(pp, H, W, tmesh,
                                                backend="kernel",
                                                slab_impl=impl)
    js = [x[0] for x in zero_state(props, 1, ring, "jax")]
    ts = [x[0].clone() for x in zero_state(props, 1, ring, "torch")]
    off, seed = 1 % t, 1
    for bi in range(2):
        raw = frames(B + (0 if ring else t), 1, 23 + bi)[0]
        flags = np.zeros(B, bool)
        flags[bi] = True
        valid = np.ones(B, bool)
        valid[3] = bi == 0
        tail = (jnp.asarray(flags), js[-1], jnp.asarray(valid))
        if ring and is_raw(props):
            jo = jstep(jnp.asarray(raw), *js[:-1], *tail, jnp.int32(seed))
            to = tstep(torch.from_numpy(raw), *ts[:-1], flags, ts[-1], valid,
                       seed)
        elif ring:
            jo = jstep(jnp.asarray(raw), *js[:-1], *tail, jnp.int32(off),
                       jnp.int32(seed))
            to = tstep(torch.from_numpy(raw), *ts[:-1], flags, ts[-1], valid,
                       off, seed)
        else:
            jo = jstep(jnp.asarray(raw), *js[:-1], *tail)
            to = tstep(torch.from_numpy(raw), *ts[:-1], flags, ts[-1], valid)
        js = list(jo[2:])
        assert all(a is b for a, b in zip(to[2:], ts))
        assert_maps(props, to[0], jo[0])
        assert_stats(to[1], jo[1])
        assert_state(ts, js)
        off, seed = (off + B) % t, 0


def test_band_exchange_of_thin_slabs():
    """Slabs of fewer than 8 rows (the plain backend): a band holds the
    neighbour's rows next to the receiver and zeros beyond them; each
    stacked section gets its own neighbour section's rows."""
    s_l, hs = 2, 6
    r = np.random.default_rng(5)
    slabs = [torch.from_numpy(r.integers(1, 256, (3, 3, s_l * hs, WP),
                                         np.uint8)) for _ in range(3)]
    bands = grid2d._band_exchange_u8(slabs, s_l)
    for j, (top, bot) in enumerate(bands):
        assert top.shape == bot.shape == (3, 3, s_l * 8, WP)
        for k in range(s_l):
            t8, b8 = top[:, :, k * 8:(k + 1) * 8], bot[:, :, k * 8:(k + 1) * 8]
            above = slabs[j - 1][:, :, k * hs:(k + 1) * hs] if j else None
            below = slabs[j + 1][:, :, k * hs:(k + 1) * hs] if j < 2 else None
            if above is None:
                assert not t8.any()
            else:
                assert torch.equal(t8[:, :, 2:], above)
                assert not t8[:, :, :2].any()
            if below is None:
                assert not b8.any()
            else:
                assert torch.equal(b8[:, :, :6], below)
                assert not b8[:, :, 6:].any()


# ---------------------------------------------------------------------------
# the port's grid against its own full-height step, both backends
# ---------------------------------------------------------------------------

PORT_CASES = [
    DiPsProperties(window_size=3, temporal_size=4),
    DiPsProperties(window_size=7, temporal_size=2,
                   method=DiPsMethod.PER_FRAME, roi=(9, 2, 15, 30)),
    DiPsProperties(window_size=5, temporal_size=3, approx_median=True,
                   output=OutputMode.GRAYSCALE,
                   filter=DiPsFilter.INVERSE_SIGMOID),
    DiPsProperties(window_size=7, temporal_size=2, quirk_compat=True),
    DiPsProperties(window_size=3, temporal_size=2, emit_maps=False),
    DiPsProperties(output=OutputMode.ABSDIFF, roi=(9, 2, 15, 30)),
    DiPsProperties(output=OutputMode.THRESHOLD,
                   method=DiPsMethod.PER_FRAME),
]


@pytest.mark.parametrize("impl", ["bands", "extended"])
@pytest.mark.parametrize("props", PORT_CASES, ids=pid)
def test_grid_ring_step_equals_full_height(props, impl):
    """Every cell of a (2, 4) grid sees only its slab and its bands, and
    the gathered result equals the full-height stacked step bit for bit,
    over two carried batches."""
    pp = props_from_jax(props)
    t = props.temporal_size
    step = grid2d.make_grid_ring_step(pp, H, W, cpu_grid(), slab_impl=impl)
    gs = zero_state(props, S, True, "torch")
    stack = lambda x, d: x.movedim(0, d).reshape(
        x.shape[1:d + 1] + (S * HP, WP)).clone()
    lead = [1, 1] if is_raw(props) else [1, 0, 0]
    fs = [stack(x, d) for x, d in zip(gs[:-1], lead)] + [stack(gs[-1], 0)]
    offs, seeds = np.arange(S, dtype=np.int32) % t, np.ones(S, np.int32)
    for bi in range(2):
        raw = torch.from_numpy(frames(B, S, 43 + bi))
        flags, valid = flags_valid(S, bi)
        if is_raw(props):
            out, stats, *_ = step(raw, *gs[:-1], flags, gs[-1], valid, seeds)
            eo, es, *_ = cuda_fused.absdiff_step_ring_stacked(
                pp, H, W, S, stack(raw, 2), *fs[:-1], flags, fs[-1], valid,
                seeds)
        else:
            out, stats, *_ = step(raw, *gs[:-1], flags, gs[-1], valid, offs,
                                  seeds)
            eo, es, *_ = cuda_fused.batch_step_ring_stacked(
                pp, H, W, S, stack(raw, 2), *fs[:-1], flags, fs[-1], valid,
                offs, seeds)
        assert torch.equal(stack(out, 2), eo)
        for g, f, d in zip(gs, fs, lead + [0]):
            assert torch.equal(stack(g, d), f)
        assert_stats(stats, es, rtol=1e-5)
        offs = (offs + B) % t
        seeds = np.zeros(S, np.int32)


@pytest.mark.parametrize("props", PORT_CASES, ids=pid)
def test_plain_backend_on_thin_slabs_equals_full_height(props):
    """24 rows on 4 row shards: 6-row slabs, which only ``backend="plain"``
    takes (the default there).  The gathered result equals the full-height
    stacked tail step bit for bit, over two carried batches."""
    h = 24
    pp = props_from_jax(props)
    t = props.temporal_size
    step = grid2d.make_grid_step(pp, h, W, cpu_grid())
    gs = zero_state(props, S, False, "torch", h)
    stack = lambda x, d: x.movedim(0, d).reshape(
        x.shape[1:d + 1] + (S * h, WP)).clone()
    lead = [1 if is_raw(props) else 0, 0]
    fs = [stack(x, d) for x, d in zip(gs, lead)]
    full = (cuda_fused.absdiff_step_stacked if is_raw(props)
            else cuda_fused.batch_step_stacked)
    for bi in range(2):
        raw = torch.from_numpy(frames(t + B, S, 53 + bi, h))
        flags, valid = flags_valid(S, bi)
        out, stats, *_ = step(raw, gs[0], flags, gs[1], valid)
        eo, es, *_ = full(pp, h, W, S, stack(raw, 2), fs[0], flags, fs[1],
                          valid)
        assert torch.equal(stack(out, 2), eo)
        for g, f, d in zip(gs, fs, lead):
            assert torch.equal(stack(g, d), f)
        assert_stats(stats, es, rtol=1e-5)


# ---------------------------------------------------------------------------
# the fleet engine on a grid
# ---------------------------------------------------------------------------

def clips(n, seed):
    return [make_clip(n=n, h=H, w=W, seed=seed + si) for si in range(S)]


def feeds_of(cl):
    """Three batches; stream 2 lags in the second, stream 1 is idle in the
    third."""
    f = [[list(c[i * B:(i + 1) * B]) for c in cl] for i in range(3)]
    f[1][2] = f[1][2][:2]
    f[2][1] = []
    return f


def run_fleet(fleet, feeds):
    return [fleet.process_batch(f) for f in feeds]


def assert_runs_same(props, got, exp, lsb=None, rtol=0.0):
    for (o, st, g), (eo, es, eg) in zip(got, exp):
        d = np.abs(np.asarray(o).astype(np.int16)
                   - np.asarray(eo).astype(np.int16))
        if lsb is None:
            lsb = 0 if is_raw(props) else 1
        assert d.max(initial=0) <= lsb
        assert_stats(st, es, rtol)
        assert abs(float(g) - float(eg)) <= 1e-6


ENGINE_CASES = [
    (DiPsProperties(window_size=3, temporal_size=2, refresh_markers=(6,)),
     True, "bands"),
    (DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2,
                    roi=(9, 2, 30, 30)), True, "bands"),
    (DiPsProperties(window_size=5, temporal_size=2,
                    method=DiPsMethod.PER_FRAME), False, "extended"),
]


@pytest.mark.parametrize("props,ring,impl", ENGINE_CASES,
                         ids=[f"{pid(p)}-{'ring' if r else 'tail'}-{i}"
                              for p, r, i in ENGINE_CASES])
def test_grid_fleet_matches_jax(props, ring, impl):
    feeds = feeds_of(clips(3 * B, 60))
    jf = JaxFleet(props, H, W, S, batch=B, mesh=jgrid.grid_mesh(2, 4),
                  backend="pallas", ring_carry=ring, slab_impl=impl)
    tf = TorchFleet(props_from_jax(props), H, W, S, batch=B, device="cpu",
                    mesh=cpu_grid(), ring_carry=ring, slab_impl=impl,
                    input_layout="planar")
    assert tf.backend == "kernel" and tf.ring_carry == ring
    assert_runs_same(props, run_fleet(tf, feeds), run_fleet(jf, feeds))
    js, ts = jf.state_dict(), tf.state_dict()
    assert ts["frame_cursors"] == js["frame_cursors"]
    np.testing.assert_array_equal(ts["baseline"][..., :H, :W],
                                  np.asarray(js["baseline"])[..., :H, :W])
    np.testing.assert_allclose(tf.heatmaps(), jf.heatmaps(), atol=1e-4)


MESHES = {
    "grid2x4": lambda: cpu_grid(2, 4),
    "grid4x2": lambda: cpu_grid(4, 2),
    "grid1x1": lambda: cpu_grid(1, 1),
    "stream2": lambda: stream_mesh(devices=["cpu"] * 2),
}


@pytest.mark.parametrize("ring", [True, False], ids=["ring", "tail"])
@pytest.mark.parametrize("mesh", ["grid2x4", "grid4x2", "grid1x1",
                                  "stream2"])
@pytest.mark.parametrize("props", [PORT_CASES[0], PORT_CASES[1],
                                   PORT_CASES[5], PORT_CASES[6]], ids=pid)
def test_grid_fleet_equals_no_mesh_fleet(props, mesh, ring):
    """Maps, stats, checkpointed state and heatmaps do not depend on the
    mesh; a lagging stream, an idle stream, a snapshot, a reset stream."""
    pp = props_from_jax(props)
    feeds = feeds_of(clips(3 * B, 70))
    runs, states = [], []
    for m in (None, MESHES[mesh]()):
        fleet = TorchFleet(pp, H, W, S, batch=B, device="cpu", mesh=m,
                           ring_carry=ring)
        res = [fleet.process_batch(feeds[0])]
        fleet.snapshot(stream=3)
        res.append(fleet.process_batch(feeds[1]))
        fleet.reset_stream(0)
        res.append(fleet.process_batch(feeds[2]))
        runs.append(res)
        states.append((fleet.state_dict(), fleet.heatmaps(),
                       fleet.stream_state_dict(2)))
    assert_runs_same(props, runs[1], runs[0], lsb=0, rtol=1e-5)
    (s0, h0, t0), (s1, h1, t1) = states
    np.testing.assert_array_equal(s1["baseline"], s0["baseline"])
    np.testing.assert_allclose(h1, h0, atol=1e-6)
    np.testing.assert_array_equal(t1["baseline"], t0["baseline"])
    for a, b in zip(s1["tails"], s0["tails"]):
        np.testing.assert_array_equal(a, b)


def test_grid_fleet_unaligned_slabs_run_the_plain_twins_on_the_cpu():
    """24 rows on 4 row shards: 6-row slabs.  CPU cells run the plain twins
    at that height, tail protocol, and the outputs equal the no-mesh
    fleet's; cells on a card refuse such slabs."""
    props = props_from_jax(DiPsProperties(window_size=5, temporal_size=2))
    cl = [make_clip(n=2 * B, h=24, w=W, seed=80 + si) for si in range(S)]
    feeds = [[list(c[i * B:(i + 1) * B]) for c in cl] for i in range(2)]
    grid = TorchFleet(props, 24, W, S, batch=B, device="cpu",
                      mesh=cpu_grid())
    assert grid.backend == "plain" and not grid.ring_carry
    flat = TorchFleet(props, 24, W, S, batch=B, device="cpu")
    before = cuda_fused.launch_counts()
    assert_runs_same(props, run_fleet(grid, feeds), run_fleet(flat, feeds),
                     lsb=0, rtol=1e-5)
    assert cuda_fused.launch_counts() == before  # CPU tensors: no launch
    with pytest.raises(ValueError, match="ring_carry"):
        TorchFleet(props, 24, W, S, batch=B, device="cpu", mesh=cpu_grid(),
                   ring_carry=True)
    with pytest.raises(ValueError, match="8-row-aligned slabs.*24 / 4"):
        TorchFleet(props, 24, W, S, batch=B, device="cpu",
                   mesh=grid_mesh(2, 4, devices=["cuda:0"] * 8))


@pytest.mark.parametrize("props", [ENGINE_CASES[0][0], ENGINE_CASES[1][0]],
                         ids=pid)
def test_grid_fleet_checkpoints_cross_meshes_and_packages(props, tmp_path):
    """A fleet saved on a grid resumes without one, in the port and in the
    JAX package, and a JAX fleet's checkpoint resumes on the port's grid:
    every resumed run equals the uninterrupted one."""
    pp = props_from_jax(props)
    feeds = feeds_of(clips(3 * B, 90))
    mk = {
        "grid": lambda: TorchFleet(pp, H, W, S, batch=B, device="cpu",
                                   mesh=cpu_grid(), input_layout="planar"),
        "flat": lambda: TorchFleet(pp, H, W, S, batch=B, device="cpu",
                                   input_layout="planar"),
        "jax": lambda: JaxFleet(props, H, W, S, batch=B,
                                mesh=jgrid.grid_mesh(2, 4),
                                backend="pallas"),
    }
    ref = run_fleet(mk["grid"](), feeds)
    for src, dst in (("grid", "flat"), ("grid", "jax"), ("jax", "grid"),
                     ("flat", "grid")):
        a = mk[src]()
        run_fleet(a, feeds[:2])
        path = str(tmp_path / f"{src}-{dst}.npz")
        a.save(path)
        b = mk[dst]()
        b.load(path)
        assert list(b.frame_cursors) == list(a.frame_cursors)
        assert_runs_same(props, [b.process_batch(feeds[2])], ref[2:])
    # one slot saved on the grid moves into a fleet without a mesh
    a, b = mk["grid"](), mk["flat"]()
    run_fleet(a, feeds[:2])
    run_fleet(b, feeds[:1])
    slot = str(tmp_path / "slot.npz")
    a.save_stream(3, slot)
    b.load_stream(3, slot)
    out = b.process_batch([[], [], [], feeds[2][3]])
    assert_runs_same(props, [(out[0][3], out[1][3], 0.0)],
                     [(ref[2][0][3], ref[2][1][3], 0.0)], lsb=0)


def test_grid_guards():
    """The JAX package's ValueErrors, and the mesh rules."""
    p3 = props_from_jax(DiPsProperties(window_size=3, temporal_size=2))
    raw = props_from_jax(DiPsProperties(output=OutputMode.ABSDIFF))
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        grid_mesh(0, 4, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        grid_mesh(2, -1, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="need 8 devices, have 3"):
        grid_mesh(2, 4, devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="need 8 devices"):
        grid_mesh(2, 4)  # the visible cards: none here
    with pytest.raises(ValueError, match="devices requested"):
        stream_mesh(2)
    assert grid2d.slab_rows_ok(32, 4) and not grid2d.slab_rows_ok(24, 4)
    for make in (grid2d.make_grid_step, grid2d.make_grid_ring_step):
        with pytest.raises(ValueError, match="slab_impl"):
            make(p3, H, W, cpu_grid(), slab_impl="nope")
    with pytest.raises(ValueError, match="8-row-aligned"):
        grid2d.make_grid_step(p3, 24, W, cpu_grid(), backend="kernel")
    for props in (p3, raw):
        with pytest.raises(ValueError, match="8-row-aligned"):
            grid2d.make_grid_ring_step(props, 24, W, cpu_grid())
    rows8 = Mesh(["cpu"] * 8, ("rows",))
    with pytest.raises(ValueError, match="8-row-aligned"):
        rowsharded.make_rowsharded_step(p3, 24, W, rows8, backend="kernel")
    for props in (p3, raw):
        with pytest.raises(ValueError, match="8-row-aligned"):
            rowsharded.make_rowsharded_ring_step(props, 24, W, rows8)
    with pytest.raises(ValueError, match="slab_impl"):
        rowsharded.make_rowsharded_step(raw, 64, W, rows8, slab_impl="nope")
    with pytest.raises(ValueError, match="slab_impl"):
        TorchFleet(p3, H, W, 2, batch=4, device="cpu", mesh=cpu_grid(),
                   slab_impl="nope")
    with pytest.raises(ValueError, match="multiple of the stream axis"):
        TorchFleet(p3, H, W, 3, batch=4, device="cpu", mesh=cpu_grid())
    with pytest.raises(ValueError, match="must divide the padded height"):
        TorchFleet(p3, H, W, 2, batch=4, device="cpu", mesh=cpu_grid(2, 3))
    with pytest.raises(ValueError, match="row slab 1 < halo 2"):
        step = grid2d.make_grid_step(
            props_from_jax(DiPsProperties(window_size=5, temporal_size=2)),
            8, W, Mesh([["cpu"] * 8], ("stream", "rows")))
        step(torch.from_numpy(frames(2 + B, 1, 1, 8)), torch.zeros(1, 8, WP),
             np.zeros((1, B), bool), torch.zeros(1, 8, WP),
             np.ones((1, B), bool))
    # the plain backend takes CPU tensors only
    with pytest.raises(ValueError, match="CPU tensors only"):
        grid2d._check_plain(p3, None, [[torch.empty(1, device="meta")]])
    # a raw engine on an aligned grid runs the slab kernels, ring-carry
    eng = TorchFleet(raw, H, W, 2, batch=2, device="cpu", mesh=cpu_grid())
    assert eng.backend == "kernel" and eng.ring_carry


def test_grid_needs_a_card_unless_asked_for_the_cpu(clip_paths, tmp_path):
    from dips_tpu_torch.errors import DeviceError
    p3 = props_from_jax(DiPsProperties())
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceError):
        TorchFleet(p3, H, W, 2, batch=4,
                   mesh=grid_mesh(2, 1, devices=["cuda:0"] * 2))
    with pytest.raises(DeviceError):
        dips_tpu_torch.run_dips_on_files(
            clip_paths[:2], str(tmp_path), mesh=cpu_grid(2, 1))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_paths(tmp_path_factory):
    d = tmp_path_factory.mktemp("grid")
    paths = []
    for si, n in enumerate((9, 6, 11, 8)):
        path = str(d / f"cam{si}.avi")
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (W, H))
        for f in make_clip(n=n, h=H, w=W, seed=20 + si):
            vw.write(f[..., ::-1])
        vw.release()
        paths.append(path)
    return paths


def test_cli_mesh_writes_the_same_files(clip_paths, tmp_path, capsys):
    runs = {"flat": [], "grid": ["--mesh", "2x4"],
            "ext": ["--mesh", "2X2", "--slab-impl", "extended"]}
    for name, extra in runs.items():
        d = tmp_path / name
        rc = dips_tpu_torch.cli.main(
            ["--inputs", *clip_paths, "--output-dir", str(d), "--encoding",
             "HFYU", "--batch", "4", "--win_size", "5", "--stats-json",
             str(d) + ".json", "--device", "cpu"] + extra)
        assert rc == 0
        assert "processed 4 streams (34 frames)" in capsys.readouterr().out
    for si in range(4):
        files = [(tmp_path / n / f"cam{si}.dips.avi").read_bytes()
                 for n in runs]
        assert files[0] == files[1] == files[2]
    import json
    docs = [json.load(open(str(tmp_path / n) + ".json")) for n in runs]
    for k in docs[0]:
        for rows in zip(*(d[k] for d in docs)):
            for r in rows[1:]:
                assert r["changed_count"] == rows[0]["changed_count"]
                assert abs(r["mean_abs_diff"]
                           - rows[0]["mean_abs_diff"]) <= 1e-6


@pytest.mark.parametrize("extra,rc,msg", [
    (["--mesh", "2y4"], 2, "bad --mesh '2y4' (want SxR, e.g. 2x4)"),
    (["--mesh", "2x"], 2, "bad --mesh"),
    (["--mesh", "1x3"], 1, "rows axis 3 must divide the padded height 32"),
    (["--mesh", "3x1"], 1, "multiple of the stream axis size 3"),
    (["--mesh", "0x4"], 1, "mesh axes must be >= 1"),
    (["--mesh", "2x4", "--device", "cuda"], 1, "error:"),
])
def test_cli_mesh_usage(clip_paths, tmp_path, capsys, extra, rc, msg):
    if "cuda" in extra and torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--inputs", *clip_paths, "--output-dir", str(tmp_path)]
    if "--device" not in extra:
        argv += ["--device", "cpu"]
    assert dips_tpu_torch.cli.main(argv + extra) == rc
    assert msg in capsys.readouterr().err


def test_cli_mesh_needs_the_inputs_mode(clip_paths, tmp_path, capsys):
    rc = dips_tpu_torch.cli.main(
        ["--input", clip_paths[0], "--output", str(tmp_path / "o.avi"),
         "--mesh", "1x2", "--device", "cpu"])
    assert rc == 2
    assert "--mesh needs the --inputs mode" in capsys.readouterr().err
