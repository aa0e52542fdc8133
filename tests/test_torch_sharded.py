"""The port's sharded multi-stream steps against the JAX package on the CPU.

* ``parallel.make_sharded_step`` / ``make_sharded_ring_step`` on
  ``stream_mesh(devices=["cpu"] * 8)`` (the stacked kernels' plain twins,
  one launch a cell) against the JAX functions on ``stream_mesh()`` over
  the 8 host devices: the tail step's "kernel" backend against Pallas in
  interpret mode, its "plain" backend against the portable XLA body, the
  ring step (Pallas only in JAX) against Pallas in interpret mode; ABSDIFF,
  THRESHOLD, STATS_ONLY and COLORIZE w3/T2, two carried batches.
* The guards: the JAX backend names and a grid mesh are refused.
* ``MultiStreamEngine(mesh=stream_mesh(...))`` against 8 single-stream
  engines (the port's mirror of ``tests/test_multistream.py::
  test_sharded_matches_single_stream``).

Inputs are made with numpy from a seed: S = 8 streams of 12 x 40 frames
(Hp = 16, Wp = 128), B = 3.  Tolerances: raw maps and carried state
byte-equal on the true H x W region (the padding columns differ by design);
median maps within 1 LSB with at most 1e-4 of the values off; stats,
heatmap and the global mean within 1e-6 (counts and maxima exact).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dips_tpu.parallel import make_sharded_ring_step as jax_ring_step
from dips_tpu.parallel import make_sharded_step as jax_step
from dips_tpu.parallel import stream_mesh as jax_stream_mesh
from dips_tpu.properties import DiPsFilter, DiPsProperties, OutputMode
from dips_tpu_torch import DiPsEngine, MultiStreamEngine
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.ops import reference as tref
from dips_tpu_torch.parallel import (grid_mesh, make_sharded_ring_step,
                                     make_sharded_step, stream_mesh)
from tests.conftest import make_clip

torch.set_num_threads(1)

H, W, S, B = 12, 40, 8, 3
HP, WP = tref.pad_geometry(H, W)
RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD, OutputMode.STATS_ONLY)

CASES = [
    DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=2),
    DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=2,
                   change_threshold=40),
    DiPsProperties(output=OutputMode.STATS_ONLY, temporal_size=2),
    DiPsProperties(window_size=3, temporal_size=2),
]
IDS = [p.output.name for p in CASES]


def cpu_mesh():
    return stream_mesh(devices=["cpu"] * S)


def is_raw(props):
    return props.output in RAW


def frames(n, seed):
    """(S, n, 3, Hp, Wp) u8: random bytes on the true region."""
    r = np.random.default_rng(seed)
    x = np.zeros((S, n, 3, HP, WP), np.uint8)
    x[..., :H, :W] = r.integers(0, 256, (S, n, 3, H, W), np.uint8)
    return x


def zero_state(props, ring):
    """Stream-leading zero state, [ring,] [prev,] baseline, heatmap, as
    numpy arrays."""
    plane = (S, HP, WP)
    if is_raw(props):
        shapes = [((S, 3, HP, WP), np.uint8)] * (2 if ring else 1)
    else:
        shapes = ([((S, props.temporal_size, HP, WP), np.float32),
                   (plane, np.float32)] if ring else []) + [
            (plane, np.float32)]
    shapes.append((plane, np.float32))
    return [np.zeros(sh, dt) for sh, dt in shapes]


def flags_valid(bi):
    """Capture on slot ``bi`` of every stream (and slot 2 of stream 0);
    the last stream's last slot invalid in the second batch."""
    flags = np.zeros((S, B), bool)
    flags[:, bi] = True
    flags[0, 2] = True
    valid = np.ones((S, B), bool)
    valid[S - 1, B - 1] = bi == 0
    return flags, valid


def assert_maps(props, got, exp):
    g = np.asarray(got)[..., :H, :W].astype(np.int16)
    e = np.asarray(exp)[..., :H, :W].astype(np.int16)
    assert g.shape == e.shape
    d = np.abs(g - e)
    if is_raw(props):
        assert d.max(initial=0) == 0
    else:
        assert d.max(initial=0) <= 1
        assert (d > 0).sum() <= 1e-4 * d.size


def assert_stats(got, exp):
    got, exp = np.asarray(got), np.asarray(exp)
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got[..., 2:], exp[..., 2:])
    np.testing.assert_allclose(got[..., :2], exp[..., :2], rtol=0, atol=1e-6)


def assert_state(got, exp):
    """[..., baseline, heatmap]: exact on the true region but the heatmap
    (within 1e-6)."""
    for g, e in zip(got[:-1], exp[:-1]):
        np.testing.assert_array_equal(np.asarray(g)[..., :H, :W],
                                      np.asarray(e)[..., :H, :W])
    np.testing.assert_allclose(np.asarray(got[-1]), np.asarray(exp[-1]),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("backend", ["kernel", "plain", None])
@pytest.mark.parametrize("props", CASES, ids=IDS)
def test_sharded_step_matches_jax(props, backend):
    """The tail protocol: "kernel" (and None) against Pallas, "plain"
    against the JAX package's XLA body."""
    pp = props_from_jax(props)
    t = props.temporal_size
    jstep = jax_step(props, H, W, jax_stream_mesh(),
                     backend="xla" if backend == "plain" else "pallas")
    tstep = make_sharded_step(pp, H, W, cpu_mesh(), backend=backend)
    js = [jnp.asarray(x) for x in zero_state(props, False)]
    ts = [torch.from_numpy(x) for x in zero_state(props, False)]
    for bi in range(2):
        raw = frames(t + B, 13 + bi)
        flags, valid = flags_valid(bi)
        jo = jstep(jnp.asarray(raw), js[0], jnp.asarray(flags), js[1],
                   jnp.asarray(valid))
        to = tstep(torch.from_numpy(raw), ts[0], flags, ts[1], valid)
        js = list(jo[2:4])
        assert to[2] is ts[0] and to[3] is ts[1]  # updated in place
        assert to[0].shape == (S, B, pp.out_channels, HP, WP)
        assert_maps(props, to[0], jo[0])
        assert_stats(to[1], jo[1])
        assert_state(ts, js)
        assert abs(float(to[4]) - float(jo[4])) <= 1e-6


@pytest.mark.parametrize("props", CASES, ids=IDS)
def test_sharded_ring_step_matches_jax(props):
    """The ring-carry protocol against the JAX step (Pallas only, in
    interpret mode here), with per-stream ring offsets and seeds."""
    pp = props_from_jax(props)
    t = props.temporal_size
    jstep = jax_ring_step(props, H, W, jax_stream_mesh())
    tstep = make_sharded_ring_step(pp, H, W, cpu_mesh())
    js = [jnp.asarray(x) for x in zero_state(props, True)]
    ts = [torch.from_numpy(x) for x in zero_state(props, True)]
    offs, seeds = np.arange(S, dtype=np.int32) % t, np.ones(S, np.int32)
    for bi in range(2):
        raw = frames(B, 3 + bi)
        flags, valid = flags_valid(bi)
        jtail = (jnp.asarray(flags), js[-1], jnp.asarray(valid))
        if is_raw(props):
            jo = jstep(jnp.asarray(raw), *js[:-1], *jtail,
                       jnp.asarray(seeds))
            to = tstep(torch.from_numpy(raw), *ts[:-1], flags, ts[-1], valid,
                       seeds)
        else:
            jo = jstep(jnp.asarray(raw), *js[:-1], *jtail, jnp.asarray(offs),
                       jnp.asarray(seeds))
            to = tstep(torch.from_numpy(raw), *ts[:-1], flags, ts[-1], valid,
                       offs, seeds)
        assert len(to) == len(jo)
        js = list(jo[2:-1])
        assert all(a is b for a, b in zip(to[2:-1], ts))  # in place
        assert_maps(props, to[0], jo[0])
        assert_stats(to[1], jo[1])
        assert_state(ts, js)
        assert abs(float(to[-1]) - float(jo[-1])) <= 1e-6
        offs = (offs + B) % t
        seeds = np.zeros(S, np.int32)


@pytest.mark.parametrize("backend", ["pallas", "xla", "auto"])
def test_sharded_step_refuses_the_jax_backends(backend):
    pp = props_from_jax(CASES[-1])
    with pytest.raises(ValueError, match="'kernel' and 'plain'"):
        make_sharded_step(pp, H, W, cpu_mesh(), backend=backend)


def test_sharded_steps_need_a_stream_mesh():
    pp = props_from_jax(CASES[-1])
    grid = grid_mesh(2, 2, devices=["cpu"] * 4)
    for make in (make_sharded_step, make_sharded_ring_step):
        with pytest.raises(ValueError, match="stream_mesh"):
            make(pp, H, W, grid)


def test_plain_backend_refuses_cuda_tensors():
    """"plain" runs the plain twins on CPU tensors only: a CUDA tensor is
    refused before any work (here a meta tensor stands in for it)."""
    pp = props_from_jax(CASES[0])
    step = make_sharded_step(pp, H, W, stream_mesh(devices=["meta"] * S),
                             backend="plain")
    state = [torch.zeros(x.shape, dtype=torch.from_numpy(x).dtype,
                         device="meta") for x in zero_state(CASES[0], False)]
    raw = torch.zeros((S, 2 + B, 3, HP, WP), dtype=torch.uint8,
                      device="meta")
    flags, valid = flags_valid(0)
    with pytest.raises(ValueError, match="CPU tensors only"):
        step(raw, state[0], flags, state[1], valid)


@pytest.mark.parametrize("ring", [True, False])
def test_sharded_matches_single_stream(ring):
    """8 streams over 8 CPU cells == 8 independent single-stream runs; the
    global mean is the host mean of the last batch's per-frame means."""
    props = props_from_jax(DiPsProperties(window_size=3, temporal_size=2,
                                          filter=DiPsFilter.UNFILTERED))
    clips = [make_clip(n=6, h=H, w=W, seed=s) for s in range(S)]
    ms = MultiStreamEngine(props, H, W, n_streams=S, batch=3, device="cpu",
                           mesh=cpu_mesh(), ring_carry=ring)
    outs, stats, gmean = [], [], []
    for i in range(0, 6, 3):
        o, st, g = ms.process_batch([list(c[i:i + 3]) for c in clips])
        outs.append(o)
        stats.append(st)
        gmean.append(g)
    out = np.concatenate(outs, axis=1)
    stat = np.concatenate(stats, axis=1)
    for s, c in enumerate(clips):
        eng = DiPsEngine(props, H, W, batch=3, device="cpu",
                         ring_carry=ring)
        exp_out, exp_stats = eng.process_frames(list(c))
        np.testing.assert_array_equal(out[s], exp_out)
        np.testing.assert_allclose(stat[s], exp_stats, atol=1e-6)
    np.testing.assert_allclose(gmean[-1], stat[:, 3:, 1].mean(), rtol=1e-5)
