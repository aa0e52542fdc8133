"""The port's engines on the tail protocol (``ring_carry=False``) on the CPU.

* ``DiPsEngine(ring_carry=False)`` against
  ``dips_tpu.DiPsEngine(backend="pallas", ring_carry=False)`` (Pallas in
  interpret mode), and equal bit for bit to the port's own ring-carry
  engine (the invariant ``tests/test_ring_carry.py`` pins for the JAX
  package).
* Checkpoints saved in one protocol continue in the other, in both
  packages.
* ``MultiStreamEngine(ring_carry=False)`` against the JAX fleet on a
  one-device stream mesh: a lagging stream, an idle stream, a stream that
  starts late, an isolated-and-revived stream, a snapshot and a fleet
  checkpoint.

Frames are made with numpy from a seed (``tests.conftest.make_clip``).
Sizes: H = 12, W = 140, B = 4, S = 3.  Tolerances: ABSDIFF / THRESHOLD
maps exact, emphasis maps within 1 LSB; stats atol 1e-6 with changed counts
and maxima exact; heatmap atol 1e-4; the baseline exact on the true region.
"""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from dips_tpu.models import DiPsEngine as JaxEngine
from dips_tpu.parallel import MultiStreamEngine as JaxFleet
from dips_tpu.parallel import stream_mesh
from dips_tpu.properties import DiPsProperties
from dips_tpu_torch import DiPsEngine as TorchEngine
from dips_tpu_torch import MultiStreamEngine as TorchFleet
from dips_tpu_torch.convert import props_from_jax
from tests.conftest import make_clip
from tests.test_ring_carry import CASES
from tests.test_torch_engine import assert_same, assert_same_state, feed
from tests.test_torch_multistream import (UNEVEN, assert_batch_same,
                                          assert_fleet_state_same, clips)

torch.set_num_threads(1)

H, W, B, S = 12, 140, 4, 3


def port(props, batch=B, ring=False):
    return TorchEngine(props_from_jax(props), H, W, batch=batch,
                       device="cpu", ring_carry=ring)


def jax_engine(props, batch=B, ring=False):
    return JaxEngine(props, H, W, batch=batch, backend="pallas",
                     ring_carry=ring)


# ---------------------------------------------------------------------------
# one stream
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("props", CASES + [DiPsProperties()])
def test_tail_engine_matches_jax(props):
    clip = make_clip(n=13, h=H, w=W, seed=11)
    jeng, teng = jax_engine(props), port(props)
    assert teng.ring_carry is False and teng.tail_rows == 0
    splits = (4, 1, 3, 4, 1)  # partial batches pad with replicas
    assert_same(props, feed(teng, clip, splits), feed(jeng, clip, splits))
    assert_same_state(jeng, teng)
    np.testing.assert_array_equal(teng.state_dict()["tail"],
                                  jeng.state_dict()["tail"])


def test_tail_engine_coprime_ring_and_batch():
    """T = 9 with B = 8 (the Pallas tail kernel runs one frame per step)."""
    props = DiPsProperties(window_size=3, temporal_size=9)
    clip = make_clip(n=16, h=H, w=W, seed=12)
    jeng, teng = jax_engine(props, 8), port(props, 8)
    assert_same(props, feed(teng, clip), feed(jeng, clip))
    assert_same_state(jeng, teng)


@pytest.mark.parametrize("props", CASES + [DiPsProperties(window_size=7,
                                                          temporal_size=5)])
def test_tail_engine_equals_ring_engine(props):
    """The two protocols, bit for bit: maps, stats, heatmap, baseline and
    the checkpoint tail, through uneven splits and a snapshot."""
    clip = make_clip(n=14, h=H, w=W, seed=13)
    res = []
    for ring in (True, False):
        eng = port(props, ring=ring)
        a = feed(eng, clip[:6], (1, 3, 2))
        eng.snapshot()
        b = feed(eng, clip[6:], (4, 2, 2))
        res.append((np.concatenate([a[0], b[0]]),
                    np.concatenate([a[1], b[1]]), eng.heatmap(),
                    eng.state_dict()))
    (ro, rs, rh, rst), (to, ts, th, tst) = res
    np.testing.assert_array_equal(to, ro)
    np.testing.assert_array_equal(ts, rs)
    np.testing.assert_array_equal(th, rh)
    np.testing.assert_array_equal(tst["baseline"], rst["baseline"])
    np.testing.assert_array_equal(tst["tail"], rst["tail"])


@pytest.mark.parametrize("props", [CASES[1], CASES[2], CASES[4]])
def test_checkpoints_cross_protocols_and_packages(props, tmp_path):
    """Save mid-stream in one protocol and package, load into another,
    continue: the continuation equals an uninterrupted run."""
    clip = make_clip(n=12, h=H, w=W, seed=14)
    ref_out, ref_stats = feed(port(props, ring=True), clip)
    makers = {"port ring": lambda: port(props, ring=True),
              "port tail": lambda: port(props, ring=False),
              "jax ring": lambda: jax_engine(props, ring=True),
              "jax tail": lambda: jax_engine(props, ring=False)}
    pairs = [("port tail", "port ring"), ("port ring", "port tail"),
             ("port tail", "jax ring"), ("jax tail", "port tail"),
             ("port tail", "port tail")]
    for i, (src_name, dst_name) in enumerate(pairs):
        src = makers[src_name]()
        src.process_frames(list(clip[:7]))
        path = str(tmp_path / f"ck{i}.npz")
        src.save(path)
        dst = makers[dst_name]()
        dst.load(path)
        got = dst.process_frames(list(clip[7:]))
        assert_same(props, got, (ref_out[7:], ref_stats[7:]))


def test_tail_engine_reset_and_empty_batch():
    props = props_from_jax(CASES[1])
    clip = make_clip(n=6, h=H, w=W, seed=15)
    eng = TorchEngine(props, H, W, batch=3, device="cpu", ring_carry=False)
    first = eng.process_frames(list(clip))
    eng.reset()
    out, stats = eng.process_batch([])
    assert out.shape == (0, H, W, 1) and stats.shape == (0, 4)
    again = eng.process_frames(list(clip))
    np.testing.assert_array_equal(first[0], again[0])
    np.testing.assert_array_equal(first[1], again[1])


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def fleets(props):
    """(the JAX fleet on one device, tail protocol; the port's)."""
    return (JaxFleet(props, H, W, n_streams=S, batch=B, mesh=stream_mesh(1),
                     backend="pallas", ring_carry=False),
            TorchFleet(props_from_jax(props), H, W, n_streams=S, batch=B,
                       device="cpu", ring_carry=False))


def feeds_of(cl, step):
    return [[] if sp is None else list(cl[si][sp[0]:sp[0] + sp[1]])
            for si, sp in enumerate(step)]


@pytest.mark.parametrize("props", [CASES[0], CASES[1], CASES[3], CASES[4],
                                   DiPsProperties(window_size=7,
                                                  temporal_size=4)])
def test_tail_fleet_matches_jax(props):
    """Uneven counts, a stream that starts late and an idle stream: the
    idle stream's stats are those of its zero rows, as the JAX fleet's."""
    cl = clips(12)
    jf, tf = fleets(props)
    assert tf.ring_carry is False
    for step in UNEVEN:
        feeds = feeds_of(cl, step)
        assert_batch_same(props, tf.process_batch(feeds),
                          jf.process_batch(feeds))
    assert_fleet_state_same(jf, tf)


@pytest.mark.parametrize("props", [CASES[0], CASES[4]])
def test_tail_fleet_isolation_snapshot_and_checkpoint(props, tmp_path):
    cl = clips(16, seed=3)
    jf, tf = fleets(props)

    def both(feeds):
        got = tf.process_batch(feeds)
        assert_batch_same(props, got, jf.process_batch(feeds))
        return got

    both([list(c[:4]) for c in cl])
    feeds = [list(c[4:8]) for c in cl]
    feeds[1][2] = np.zeros((H, W + 1, 3), np.uint8)  # isolates stream 1
    for f in (jf, tf):
        f.snapshot(stream=2)
    both(feeds)
    assert set(tf.failed) == {1}
    # the fleet checkpoint, in each package, continues in the other
    jf.save(str(tmp_path / "j.npz"))
    tf.save(str(tmp_path / "t.npz"))
    jf2, tf2 = fleets(props)
    jf2.load(str(tmp_path / "t.npz"))
    tf2.load(str(tmp_path / "j.npz"))
    assert set(tf2.failed) == {1}
    for f in (jf2, tf2):
        f.revive(1)
    jf, tf = jf2, tf2
    both([list(cl[0][8:12]), list(cl[1][4:8]), list(cl[2][8:12])])
    both([list(cl[0][12:16]), list(cl[1][8:12]), []])
    assert_fleet_state_same(jf, tf)
    assert tf.frame_cursors == [16, 12, 12]


@pytest.mark.parametrize("props", [CASES[1], CASES[3]])
def test_tail_fleet_equals_ring_fleet(props):
    """Tail and ring fleets agree, bit for bit, on every staged stream's
    slots (an idle stream's slots differ by design: each protocol diffs its
    zero rows against what it carries)."""
    cl = clips(12, seed=4)
    res = []
    for ring in (True, False):
        f = TorchFleet(props_from_jax(props), H, W, n_streams=S, batch=B,
                       device="cpu", ring_carry=ring)
        res.append([f.process_batch(feeds_of(cl, step)) for step in UNEVEN]
                   + [f.heatmaps()])
    for bi, step in enumerate(UNEVEN):
        for si, sp in enumerate(step):
            if sp is None:
                continue
            for k in (0, 1):
                np.testing.assert_array_equal(res[1][bi][k][si, :sp[1]],
                                              res[0][bi][k][si, :sp[1]])
    np.testing.assert_array_equal(res[1][-1], res[0][-1])


def test_tail_fleet_slot_checkpoint_moves_to_a_single_engine(tmp_path):
    props = CASES[4]
    cl = clips(8, seed=5)
    _, tf = fleets(props)
    tf.process_batch([list(c[:4]) for c in cl])
    tf.save_stream(2, str(tmp_path / "slot.npz"))
    one = port(props)
    one.load(str(tmp_path / "slot.npz"))
    got = one.process_batch(list(cl[2][4:8]))
    exp = tf.process_batch([list(c[4:8]) for c in cl])
    np.testing.assert_array_equal(got[0], exp[0][2])
    np.testing.assert_array_equal(got[1], exp[1][2])
