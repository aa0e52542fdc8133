"""The port's daemon against the JAX package's, on the CPU.

* Replies: the same seed-made clips through ``dips_tpu.serve.DiPsServer(...,
  backend="pallas")`` (Pallas in interpret mode, the ring-carry protocol)
  and the port's ``DiPsServer(..., device="cpu")``, dedicated and
  coalesced (3 slots, 3 concurrent clients), OVERALL and PER_FRAME,
  COLORIZE and ABSDIFF: maps, stats and heatmaps; packed THRESHOLD reply
  bytes (device-packed ``packed_wire`` planes and host-packed masks);
  flicker maps of a dedicated and a coalesced session.
* The surface: ``hello``'s config and ``metrics`` have the same keys, the
  Prometheus text the same families.
Clients and checkpoints across the packages and the daemon CLI's usage
errors: ``tests/test_torch_serve_jax_io.py``.

Sizes: H = 12, W = 140 (Hp = 16, Wp = 256), B = 2, w3/T4.  Tolerances, as
in ``tests/test_torch_multistream.py``: raw maps exact; emphasis maps
within 1 LSB with at most 1e-4 of the values flipped; stats atol 1e-6 with
maxima and counts exact; heatmap atol 1e-6; packed bytes exact; flicker
maps rtol 1e-5 + atol 1e-4 (``tests/test_torch_analysis.py``).
"""

import threading

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.serve as jserve
import dips_tpu_torch.serve as tserve
from dips_tpu.properties import DiPsMethod, DiPsProperties, OutputMode
from dips_tpu_torch.convert import props_from_jax
from tests._torch_serve import blink_frames
from tests.conftest import make_clip

torch.set_num_threads(1)

H, W, B = 12, 140, 2
RAW = (OutputMode.ABSDIFF, OutputMode.THRESHOLD, OutputMode.STATS_ONLY)
AMP_TOL = dict(rtol=1e-5, atol=1e-4)


def serve_pair(props, **kw):
    """The JAX daemon and the port's on the same props, both serving."""
    js = jserve.DiPsServer(props, H, W, port=0, batch=B, backend="pallas",
                           **kw)
    ts = tserve.DiPsServer(props_from_jax(props), H, W, port=0, batch=B,
                           device="cpu", **kw)
    for srv in (js, ts):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    return js, ts


def assert_maps(got, exp, props):
    if props.output in RAW:
        np.testing.assert_array_equal(got, exp)
        return
    d = np.abs(got.astype(np.int16) - exp.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d > 0).mean() <= 1e-4, (d > 0).mean()


def assert_stats(got, exp):
    np.testing.assert_allclose(got, exp, atol=1e-6)
    np.testing.assert_array_equal(got[:, 2:], exp[:, 2:])  # max, count


def session(port, clip, client=tserve.DiPsClient, **kw):
    """4 frames, a snapshot, 3 frames, the heatmap: (maps, stats, heat)."""
    with client(port, **kw) as cli:
        o1, s1 = cli.process_many(clip[:4])
        cli.snapshot()
        o2, s2 = cli.process_many(clip[4:])
        heat = cli.heatmap()
    return np.concatenate([o1, o2]), np.concatenate([s1, s2]), heat


def concurrent_sessions(port, clips, **kw):
    out = [None] * len(clips)
    errors = []

    def run(i):
        try:
            out[i] = session(port, clips[i], **kw)
        except Exception as e:  # surface thread failures to pytest
            errors.append((i, repr(e)))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(clips))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not errors, errors
    assert not any(t.is_alive() for t in ts)
    return out


MODES = [
    DiPsProperties(window_size=3, temporal_size=4),
    DiPsProperties(window_size=3, temporal_size=4,
                   method=DiPsMethod.PER_FRAME),
    DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=4),
    DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=4,
                   method=DiPsMethod.PER_FRAME),
]


@pytest.mark.parametrize("coalesce", [0, 3], ids=["dedicated", "coalesced"])
@pytest.mark.parametrize("props", MODES, ids=["overall", "per_frame",
                                              "absdiff", "absdiff_pf"])
def test_replies_match_the_jax_daemon(props, coalesce):
    n = 3 if coalesce else 1
    clips = [make_clip(n=7, h=H, w=W, seed=40 + i) for i in range(n)]
    js, ts = serve_pair(props, coalesce=coalesce, max_sessions=n)
    try:
        # each client's replies are its own stream's, whichever slot
        got = concurrent_sessions(ts.port, clips)
        exp = concurrent_sessions(js.port, clips)
    finally:
        js.shutdown()
        ts.shutdown()
    for (tm, tst, th), (jm, jst, jh) in zip(got, exp):
        assert tm.shape == jm.shape == (7, H, W, props.out_channels)
        assert_maps(tm, jm, props)
        assert_stats(tst, jst)
        np.testing.assert_allclose(th, jh, atol=1e-6)


@pytest.mark.parametrize("packed_wire", [True, False],
                         ids=["device_packed", "host_packed"])
def test_packed_threshold_bytes_match_the_jax_daemon(packed_wire):
    """``packed: true`` replies carry the same bytes: the device-packed
    padded planes of a ``packed_wire`` engine, forwarded verbatim with
    ``padded``, or the host-packed masks."""
    props = DiPsProperties(output=OutputMode.THRESHOLD, temporal_size=4,
                           change_threshold=20)
    clip = make_clip(n=4, h=H, w=W, seed=7)
    js, ts = serve_pair(props, packed_wire=packed_wire)
    replies = []
    try:
        for srv in (js, ts):
            with tserve.DiPsClient(srv.port) as cli:
                payload = clip.tobytes()
                replies.append(cli._rpc({"cmd": "process_batch",
                                         "shape": list(clip.shape),
                                         "packed": True}, payload))
    finally:
        js.shutdown()
        ts.shutdown()
    (jh, jb), (th, tb) = replies
    assert th["packed"] is jh["packed"] is True
    assert th.get("padded") == jh.get("padded")
    assert (th.get("padded") is not None) == packed_wire
    assert th["shape"] == jh["shape"] == [4, H, W, 1]
    assert tb == jb
    assert_stats(np.asarray(th["stats"]), np.asarray(jh["stats"]))


@pytest.mark.parametrize("coalesce", [0, 2], ids=["dedicated", "coalesced"])
def test_flicker_maps_match_the_jax_daemon(coalesce):
    props = DiPsProperties(window_size=1, temporal_size=1)
    frames = blink_frames(20, H, W, 24.0, 6.0)
    js, ts = serve_pair(props, coalesce=coalesce)
    maps = []
    try:
        for srv in (js, ts):
            with tserve.DiPsClient(srv.port, session="cam", flicker_hz=6.0,
                                   flicker_fps=24.0) as cli:
                cli.process_many(frames[:7])
                cli.process_many(frames[7:])
                amp, meta = cli.flicker()
                assert meta == {"freq_hz": 6.0, "frames": 20}
                maps.append(amp)
    finally:
        js.shutdown()
        ts.shutdown()
    assert maps[1].shape == (H, W)
    np.testing.assert_allclose(maps[1], maps[0], **AMP_TOL)


@pytest.mark.parametrize("coalesce", [0, 2], ids=["dedicated", "coalesced"])
def test_hello_metrics_and_prometheus_keys_match(coalesce):
    props = DiPsProperties(window_size=3, temporal_size=4)
    clip = make_clip(n=3, h=H, w=W, seed=3)
    js, ts = serve_pair(props, coalesce=coalesce)
    seen = []
    try:
        for srv in (js, ts):
            with tserve.DiPsClient(srv.port) as cli:
                cli.process_many(clip)
                seen.append((cli.hello(), cli.metrics()))
    finally:
        js.shutdown()
        ts.shutdown()
    (jh, jm), (th, tm) = seen
    assert set(th["config"]) == set(jh["config"])
    assert th["config"]["backend"] == "plain"  # plain twins on the CPU
    for key in set(jh["config"]) - {"backend"}:
        assert th["config"][key] == jh["config"][key], key
    assert set(tm) == set(jm)

    def families(m):
        return {ln for ln in jserve._prometheus_text(m).splitlines()
                if ln.startswith("# TYPE")}

    assert families(tm) == families(jm)
