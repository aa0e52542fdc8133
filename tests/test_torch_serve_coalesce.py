"""The port's coalesced and geometry-flexible daemons on the CPU: sessions
folded into one stacked ``MultiStreamEngine`` launch (per-slot state,
save / load, park and eviction, stress, ``coalesce_devices`` and
``coalesce_mesh`` over CPU cells), per-geometry coalescers and engine
pools, ``warm``, churn and eviction; each case of ``tests/test_serve.py``
with the port's single-stream engine as the expectation."""

import threading

import numpy as np
import pytest
import torch

from dips_tpu_torch.properties import DiPsFilter, DiPsProperties
from dips_tpu_torch.serve import DiPsClient
from tests._torch_serve import (DiPsEngine, DiPsServer, blink_frames,
                                coalesced_server, flexible_server)
from tests.conftest import make_clip

torch.set_num_threads(1)


def test_coalesced_sessions_match_dedicated_engines():
    """3 concurrent clients on one coalescer must each get EXACTLY what a
    dedicated single-stream engine computes on their frames (private
    baseline/ring/cursor per slot, despite shared dispatches)."""
    srv, props = coalesced_server(3)
    try:
        clips = [make_clip(n=6, h=16, w=24, seed=20 + i) for i in range(3)]
        results = [None] * 3

        def run(i):
            cli = DiPsClient(srv.port)
            assert cli.hello()["config"]["coalesced"] is True
            outs, stats = [], []
            for f in clips[i]:
                o, s = cli.process(f)
                outs.append(o)
                stats.append(s)
            cli.close()
            results[i] = (np.stack(outs), np.stack(stats))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        for i in range(3):
            assert results[i] is not None, f"client {i} did not finish"
            eng = DiPsEngine(props, 16, 24, batch=1)
            exp_out, exp_stats = eng.process_frames(list(clips[i]))
            np.testing.assert_array_equal(results[i][0], exp_out)
            np.testing.assert_allclose(results[i][1], exp_stats, atol=1e-6)
    finally:
        srv.shutdown()


def test_coalesced_batched_requests_and_snapshot():
    srv, props = coalesced_server(2)
    try:
        clip = make_clip(n=6, h=16, w=24, seed=31)
        cli = DiPsClient(srv.port)
        outs, stats = cli.process_many(clip[:4])  # spans two device batches
        assert outs.shape == (4, 16, 24, 3)
        cli.snapshot()
        _, s = cli.process(clip[4])
        assert s[1] == 0  # forced re-capture -> zero diff
        hm = cli.heatmap()
        assert hm.shape == (16, 24) and hm.max() > 0
        cli.close()
    finally:
        srv.shutdown()


def test_coalesced_save_load_roundtrip(tmp_path):
    """Per-slot save/load on a coalesced server: a session rewinds to its
    checkpoint and continues bit-identically while its co-tenant streams on
    unaffected."""
    srv, props = coalesced_server(2)
    try:
        clip_a = make_clip(n=6, h=16, w=24, seed=60)
        clip_b = make_clip(n=6, h=16, w=24, seed=61)
        path = str(tmp_path / "slot.npz")
        a = DiPsClient(srv.port, session="cam-A")
        b = DiPsClient(srv.port, session="cam-B")
        outs_a = [a.process(f)[0] for f in clip_a[:3]]
        outs_b = [b.process(f)[0] for f in clip_b[:3]]
        a.save(path)
        a.process(clip_a[4])            # wander past the checkpoint...
        assert a.load(path) == 3        # ...and rewind to it
        outs_a += [a.process(f)[0] for f in clip_a[3:]]
        outs_b += [b.process(f)[0] for f in clip_b[3:]]
        a.close()
        b.close()
        for clip, outs in ((clip_a, outs_a), (clip_b, outs_b)):
            eng = DiPsEngine(props, 16, 24, batch=1)
            exp, _ = eng.process_frames(list(clip))
            np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()


def test_session_migrates_between_dedicated_and_coalesced(tmp_path):
    """Checkpoints are DiPsEngine-format on both server kinds, so a camera
    session saved on a dedicated server resumes inside a coalesced slot."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    clip = make_clip(n=6, h=16, w=24, seed=62)
    path = str(tmp_path / "mig.npz")
    ded = DiPsServer(props, 16, 24, port=0, batch=1)
    threading.Thread(target=ded.serve_forever, daemon=True).start()
    try:
        cli = DiPsClient(ded.port)
        outs = [cli.process(f)[0] for f in clip[:3]]
        cli.save(path)
        cli.close()
    finally:
        ded.shutdown()
    srv, _ = coalesced_server(2)
    try:
        cli = DiPsClient(srv.port, session="cam-M")
        assert cli.load(path) == 3
        outs += [cli.process(f)[0] for f in clip[3:]]
        cli.close()
    finally:
        srv.shutdown()
    eng = DiPsEngine(props, 16, 24, batch=1)
    exp, _ = eng.process_frames(list(clip))
    np.testing.assert_array_equal(np.stack(outs), exp)


def test_coalesced_named_session_resumes_anonymous_does_not():
    srv, props = coalesced_server(2)
    try:
        clip = make_clip(n=4, h=16, w=24, seed=40)
        a1 = DiPsClient(srv.port, session="cam-A")
        outs = [a1.process(f)[0] for f in clip[:2]]
        a1.close()
        anon = DiPsClient(srv.port)  # fresh slot, not cam-A's state
        assert anon.hello()["frame_index"] == 0
        anon.close()
        a2 = DiPsClient(srv.port, session="cam-A")
        assert a2.hello()["frame_index"] == 2  # resumed slot
        outs += [a2.process(f)[0] for f in clip[2:]]
        a2.close()
        eng = DiPsEngine(props, 16, 24, batch=1)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()


def test_coalesced_slot_exhaustion_evicts_oldest_parked():
    """All slots parked under named tokens: a new client evicts the oldest
    parked session instead of being refused."""
    srv, _ = coalesced_server(2)
    try:
        clip = make_clip(n=3, h=16, w=24, seed=50)
        for name in ("cam-A", "cam-B"):
            c = DiPsClient(srv.port, session=name)
            c.process(clip[0])
            c.close()
        c = DiPsClient(srv.port, session="cam-C")  # evicts cam-A
        assert c.hello()["frame_index"] == 0
        c.process(clip[1])
        c.close()
        b = DiPsClient(srv.port, session="cam-B")  # survived
        assert b.hello()["frame_index"] == 1
        b.close()
        a = DiPsClient(srv.port, session="cam-A")  # evicted -> fresh
        assert a.hello()["frame_index"] == 0
        a.close()
    finally:
        srv.shutdown()


def test_coalesced_bad_frame_isolated_per_request():
    srv, _ = coalesced_server(2)
    try:
        cli = DiPsClient(srv.port)
        with pytest.raises(RuntimeError):
            cli.process(np.zeros((3, 3, 3), np.uint8))
        out, _ = cli.process(make_clip(n=1, h=16, w=24)[0])
        assert out.shape == (16, 24, 3)
        cli.close()
    finally:
        srv.shutdown()


def test_coalesced_concurrent_stress_random_ops():
    """4 clients fire interleaved random command mixes at one coalescer;
    nothing deadlocks, every reply is sane, and the daemon finishes all
    sessions (races in the dispatcher would hang or cross wires here)."""
    srv, _ = coalesced_server(4, h=8, w=16)
    try:
        rng = np.random.default_rng(0)
        clip = make_clip(n=8, h=8, w=16, seed=60)
        errors = []

        def run(i):
            try:
                with DiPsClient(srv.port, session=f"s{i}") as cli:
                    r = np.random.default_rng(i)
                    for _ in range(12):
                        op = r.integers(0, 10)
                        if op < 6:
                            o, s = cli.process(clip[r.integers(0, 8)])
                            assert o.shape == (8, 16, 3)
                            assert np.isfinite(s).all()
                        elif op < 8:
                            o, s = cli.process_many(
                                clip[:int(r.integers(1, 5))])
                            assert np.isfinite(s).all()
                        elif op == 8:
                            cli.snapshot()
                        else:
                            cli.reset()
            except Exception as e:  # surface thread failures to pytest
                errors.append((i, repr(e)))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=90)
        assert not errors, errors
        assert not any(t.is_alive() for t in ts), "stress run deadlocked"
    finally:
        srv.shutdown()


def test_coalesced_slots_shard_over_mesh():
    """coalesce_devices=4: 8 session slots shard over a 4-device virtual
    mesh; a client on each shard still gets exactly the dedicated-engine
    result (the multi-chip camera-fleet deployment shape)."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, coalesce=8,
                     coalesce_devices=4)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        assert srv._coalescer.engine.mesh.devices.size == 4
        clips = [make_clip(n=4, h=16, w=24, seed=80 + i) for i in range(8)]
        results = [None] * 8

        def run(i):
            with DiPsClient(srv.port) as cli:
                results[i] = np.stack(
                    [cli.process(f)[0] for f in clips[i]])

        ts = [threading.Thread(target=run, args=(i,)) for i in range(8)]
        for th in ts:
            th.start()
        for th in ts:
            th.join(timeout=90)
        # slot assignment order is nondeterministic under concurrency, so
        # match each result to the clip its client streamed
        for i in range(8):
            assert results[i] is not None
            eng = DiPsEngine(props, 16, 24, batch=1)
            exp, _ = eng.process_frames(list(clips[i]))
            np.testing.assert_array_equal(results[i], exp)
    finally:
        srv.shutdown()


def test_metrics_coalesce_fill(tmp_path):
    """Coalesced servers report device dispatches and mean request fill."""
    srv, _ = coalesced_server(2)
    try:
        clip = make_clip(n=4, h=16, w=24, seed=91)
        with DiPsClient(srv.port) as cli:
            for f in clip:
                cli.process(f)
            m = cli.metrics()
        assert m["coalesced"] is True
        assert m["coalesce_dispatches"] >= 1
        # single client: each dispatch folded exactly its one frame
        assert 1.0 <= m["coalesce_mean_fill"] <= 2.0
        assert m["latency_ms"]["count"] == 4
    finally:
        srv.shutdown()


def test_coalesced_hwc_input_layout_matches():
    """A coalesced server with input_layout='hwc' (device-side planarize)
    serves bit-identical results."""
    srv, props = coalesced_server(2, input_layout="hwc")
    try:
        clip = make_clip(n=4, h=16, w=24, seed=70)
        with DiPsClient(srv.port) as cli:
            outs = [cli.process(f)[0] for f in clip]
        eng = DiPsEngine(props, 16, 24, batch=1)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()


def test_flexible_geometry_mixed_fleet():
    """A daemon started WITHOUT height/width serves sessions of different
    resolutions, each sized from its first frame and bit-exact vs a
    dedicated engine."""
    srv, props = flexible_server()
    try:
        clip_a = make_clip(n=4, h=16, w=24, seed=80)
        clip_b = make_clip(n=4, h=12, w=40, seed=81)
        a = DiPsClient(srv.port, session="cam-A")
        b = DiPsClient(srv.port, session="cam-B")
        # geometry-free commands answer before any frame
        info = a.hello()
        assert info["ok"] and info["config"]["height"] is None
        assert a.metrics()["ok"]
        # state commands need a frame first -> clean error, session survives
        with pytest.raises(RuntimeError, match="geometry"):
            a.snapshot()
        outs_a = [a.process(f)[0] for f in clip_a]
        outs_b = [b.process(f)[0] for f in clip_b]
        assert a.hello()["config"]["height"] == 16
        a.close()
        b.close()
        for (h, w, clip, outs) in ((16, 24, clip_a, outs_a),
                                   (12, 40, clip_b, outs_b)):
            eng = DiPsEngine(props, h, w, batch=2)
            exp, _ = eng.process_frames(list(clip))
            np.testing.assert_array_equal(np.stack(outs), exp)
        with DiPsClient(srv.port) as mon:
            m = mon.metrics()
        assert m["flexible"] is True and m["parked_sessions"] == 2
    finally:
        srv.shutdown()


def test_flexible_named_resume_and_checkpoint_load(tmp_path):
    """Flexible daemon: named sessions park/resume across reconnects, and a
    brand-new session can bind its geometry from a checkpoint file."""
    srv, props = flexible_server()
    path = str(tmp_path / "flex.npz")
    try:
        clip = make_clip(n=6, h=16, w=24, seed=82)
        c1 = DiPsClient(srv.port, session="cam-R")
        for f in clip[:3]:
            c1.process(f)
        c1.save(path)
        c1.close()
        c2 = DiPsClient(srv.port, session="cam-R")
        assert c2.hello()["frame_index"] == 3  # parked state resumed
        outs = [c2.process(f)[0] for f in clip[3:]]
        c2.close()
        eng = DiPsEngine(props, 16, 24, batch=2)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp[3:])

        # fresh anonymous session binds geometry (and state) from the file
        c3 = DiPsClient(srv.port)
        assert c3.load(path) == 3
        out3, _ = c3.process(clip[3])
        np.testing.assert_array_equal(out3, exp[3])
        c3.close()
    finally:
        srv.shutdown()


def test_flexible_coalesce_per_geometry():
    """A flexible daemon with coalesce=N creates one stacked-stream
    coalescer PER GEOMETRY lazily: mixed-resolution camera fleets still
    share device dispatches within each resolution, with per-slot state
    bit-exact vs dedicated engines."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, port=0, batch=2, coalesce=2, max_sessions=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        srv.warm_geometries(["16x24"])  # warm one bucket up front
        geoms = [(16, 24), (16, 24), (12, 40), (12, 40)]
        clips = [make_clip(n=4, h=h, w=w, seed=130 + i)
                 for i, (h, w) in enumerate(geoms)]
        results = [None] * 4
        errors = []

        def cam(i):
            try:
                with DiPsClient(srv.port, session=f"g{i}") as cli:
                    results[i] = [cli.process(f)[0] for f in clips[i]]
            except Exception as e:
                errors.append((i, repr(e)))

        ts = [threading.Thread(target=cam, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors
        for i, (h, w) in enumerate(geoms):
            eng = DiPsEngine(props, h, w, batch=2)
            exp, _ = eng.process_frames(list(clips[i]))
            np.testing.assert_array_equal(np.stack(results[i]), exp)
        with DiPsClient(srv.port) as mon:
            m = mon.metrics()
        assert m["coalesced"] is True and m["flexible"] is True
        assert m["coalesce_dispatches"] >= 1
        # a named session resumes on ITS geometry's coalescer
        with DiPsClient(srv.port, session="g0") as cli:
            assert cli.hello()["frame_index"] == 4
    finally:
        srv.shutdown()


def test_flexible_bad_load_path_survives():
    """A bad checkpoint path on a flexible daemon replies a clean error
    (the geometry peek must not drop the connection)."""
    srv, _ = flexible_server()
    try:
        with DiPsClient(srv.port) as cli:
            with pytest.raises(RuntimeError):
                cli.load("/nonexistent/nope.npz")
            out, _ = cli.process(make_clip(n=1, h=16, w=24)[0])
            assert out.shape == (16, 24, 3)
    finally:
        srv.shutdown()


def test_warm_geometries_prebuilds_pool():
    """warm_geometries pre-compiles pooled engines so the first camera of
    a resolution reuses one; bad specs and fixed-server mismatches fail
    loudly."""
    srv, props = flexible_server()
    try:
        srv.warm_geometries(["16x24"])
        with DiPsClient(srv.port) as mon:
            assert mon.metrics()["pooled_engines"] == {"16x24": 1}
        clip = make_clip(n=2, h=16, w=24, seed=95)
        with DiPsClient(srv.port) as cli:
            outs = [cli.process(f)[0] for f in clip]
        eng = DiPsEngine(props, 16, 24, batch=2)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
        with pytest.raises(ValueError, match="bad geometry"):
            srv.warm_geometries(["16by24"])
    finally:
        srv.shutdown()
    fixed = DiPsServer(DiPsProperties(window_size=1, temporal_size=1),
                       16, 24, port=0)
    try:
        fixed.warm_geometries(["16x24"])  # matching: allowed
        with pytest.raises(ValueError, match="fixed server"):
            fixed.warm_geometries(["1080p"])
    finally:
        fixed.shutdown()


def test_flexible_concurrent_churn_stress(tmp_path):
    """Mixed-geometry clients churn connect/process/save/load/close against
    one flexible daemon; no deadlocks, no cross-geometry state leaks, every
    named session's cursor stays consistent across its reconnect cycles."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, port=0, batch=2, max_sessions=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    geoms = [(16, 24), (8, 16), (12, 40)]
    errors = []

    def run(i):
        h, w = geoms[i % len(geoms)]
        clip = make_clip(n=6, h=h, w=w, seed=120 + i)
        count = 0
        try:
            for cycle in range(3):  # reconnect churn
                with DiPsClient(srv.port, session=f"cam{i}") as cli:
                    assert cli.hello()["frame_index"] == count, (i, cycle)
                    r = np.random.default_rng(100 + 10 * i + cycle)
                    for _ in range(int(r.integers(1, 4))):
                        o, s = cli.process(clip[count % 6])
                        assert o.shape == (h, w, 3), (i, o.shape)
                        assert np.isfinite(s).all()
                        count += 1
                    if cycle == 1:
                        p = str(tmp_path / f"c{i}.npz")
                        cli.save(p)
                        assert cli.load(p) == count
        except Exception as e:
            errors.append((i, repr(e)))

    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors, errors
        assert not any(t.is_alive() for t in ts), "churn deadlocked"
        with DiPsClient(srv.port) as mon:
            m = mon.metrics()
        assert m["parked_sessions"] == 4 and m["request_errors"] == 0
    finally:
        srv.shutdown()


def test_abortive_disconnect_frees_coalescer_slot():
    """A client killed mid-stream (RST, not a clean close) must not leak
    its bound slot: the engine holder releases it on ANY exit path."""
    import socket as socket_mod
    import struct
    import time

    srv, props = coalesced_server(1)  # ONE slot: a leak blocks everyone
    try:
        f = make_clip(n=1, h=16, w=24)[0]
        for _ in range(3):  # repeat: each leaked slot would be fatal
            c = DiPsClient(srv.port)
            c.process(f)  # binds the only slot
            # abortive close: SO_LINGER(on, 0) makes close() send RST, so
            # the server's recv raises ConnectionResetError mid-session
            c._sock.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_LINGER,
                               struct.pack("ii", 1, 0))
            c._sock.close()
            # the slot must come back for the next client
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                with srv._pool_lock:
                    co = srv._coalescer
                with co._cv:
                    if not co._bound:
                        break
                time.sleep(0.05)
            else:
                raise AssertionError("slot still bound after RST")
    finally:
        srv.shutdown()


def test_slow_mid_message_does_not_desync_protocol():
    """The 0.5s idle poll must not fire mid-message: a request trickling
    in slower than the poll interval still parses and gets a reply."""
    import socket as socket_mod
    import json as json_mod
    import struct

    srv, props = coalesced_server(1)
    try:
        f = make_clip(n=1, h=16, w=24)[0]
        payload = np.ascontiguousarray(f).tobytes()
        hdr = json_mod.dumps({"cmd": "process", "shape": list(f.shape),
                              "payload_len": len(payload)}).encode()
        msg = struct.pack("<I", len(hdr)) + hdr + payload
        s = socket_mod.create_connection(("127.0.0.1", srv.port))
        # drip the request in 3 chunks with >0.5s pauses
        import time
        third = len(msg) // 3
        for chunk in (msg[:third], msg[third:2 * third], msg[2 * third:]):
            s.sendall(chunk)
            time.sleep(0.7)
        raw = s.recv(4)
        n = struct.unpack("<I", raw)[0]
        buf = b""
        while len(buf) < n:
            buf += s.recv(n - len(buf))
        reply = json_mod.loads(buf)
        assert reply["ok"], reply
        s.close()
    finally:
        srv.shutdown()


def test_duplicate_token_park_releases_superseded_slot():
    """Camera reconnects with its token while the old connection still
    drains: when both park, the superseded slot must be freed (was: leaked
    unreachably, exhausting the coalescer)."""
    srv, props = coalesced_server(2)
    try:
        a = srv._bind_engine("cam")        # slot for connection A
        b = srv._bind_engine("cam")        # reconnect before A parks
        srv._release_engine(a)             # A parks under "cam"
        srv._release_engine(b)             # B supersedes A's parked slot
        # both slots must now be obtainable (one free, one via eviction)
        x = srv._bind_engine(None)
        y = srv._bind_engine(None)
        assert {x.slot, y.slot} == {0, 1}
    finally:
        srv.shutdown()


def test_flexible_hello_reports_coalesced_before_bind():
    srv, props = flexible_server(coalesce=2)
    try:
        with DiPsClient(srv.port) as c:
            assert c.hello()["config"]["coalesced"] is True
    finally:
        srv.shutdown()


def test_bad_shape_strings_get_error_reply():
    """Non-numeric shape entries on the first request must produce an
    error reply, not a silent connection drop."""
    srv, props = flexible_server()
    try:
        c = DiPsClient(srv.port)
        h, _ = c._rpc({"cmd": "process", "shape": ["a", "b", "c"]})
        assert not h["ok"] and "bad shape" in h["error"]
        # connection survives for a correct request
        o, _ = c.process(make_clip(n=1, h=16, w=24)[0])
        assert o.shape == (16, 24, 3)
        c.close()
    finally:
        srv.shutdown()


def test_geometry_churn_evicts_idle_state():
    """Geometry churn must not accumulate unbounded engines/coalescers:
    idle per-geometry state beyond the caps is evicted."""
    # flexible NON-coalesced: pooled engines capped
    srv, props = flexible_server()
    try:
        srv.max_pooled_engines = 2
        geoms = [(16, 24), (24, 24), (32, 24)]
        for h, w in geoms:
            with DiPsClient(srv.port) as c:
                c.process(np.zeros((h, w, 3), np.uint8))
        with srv._pool_lock:
            total = sum(len(v) for v in srv._pool.values())
        assert total <= 2
    finally:
        srv.shutdown()

    # flexible coalesced: idle coalescers capped
    srv, props = flexible_server(coalesce=1)
    try:
        srv.max_geometries = 2
        for h, w in geoms:
            with DiPsClient(srv.port) as c:
                c.process(np.zeros((h, w, 3), np.uint8))
        with srv._pool_lock:
            n = len(srv._coalescers)
        assert n <= 2
    finally:
        srv.shutdown()


def test_flexible_prebind_hello_waits_for_token_takeover():
    """Reconnect race on a flexible daemon: a pre-bind hello with a token
    whose old connection has not yet parked must kick + wait, then report
    the TRUE cursor — not frame_index 0 (which a resilient client would
    misread as server-side state loss)."""
    import socket as sk
    import struct

    srv, props = flexible_server()
    try:
        c1 = DiPsClient(srv.port, session="cam")
        c1.process(make_clip(n=1, h=16, w=24)[0])
        c1.process(make_clip(n=1, h=16, w=24)[0])
        # abortive RST: the server may not have parked "cam" yet
        c1._sock.setsockopt(sk.SOL_SOCKET, sk.SO_LINGER,
                            struct.pack("ii", 1, 0))
        c1._sock.close()
        c2 = DiPsClient(srv.port, session="cam")  # immediate reconnect
        assert c2.hello()["frame_index"] == 2
        c2.close()
    finally:
        srv.shutdown()


def test_per_session_roi_rejected_when_coalescing():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, coalesce=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        with DiPsClient(srv.port, roi=(0, 0, 8, 8)) as cli:
            with pytest.raises(RuntimeError, match="coalescing"):
                cli.process(np.zeros((16, 24, 3), np.uint8))
    finally:
        srv.shutdown()


def test_flicker_on_coalesced_session():
    """Flicker is a separate per-session device stream, so unlike roi it
    works on coalescing daemons too."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, coalesce=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        fps, hz = 24.0, 6.0
        frames = blink_frames(24, 16, 24, fps, hz)
        with DiPsClient(srv.port, session="cam", flicker_hz=hz,
                        flicker_fps=fps) as cli:
            for f in frames:
                cli.process(f)
            amp, meta = cli.flicker()
            assert meta["frames"] == len(frames)
            assert amp[2:6, 3:9].mean() > amp[10:, 12:].mean()
    finally:
        srv.shutdown()


def test_serve_downscale_flexible_pool_and_checkpoint(tmp_path):
    """Flexible downscale daemon: sessions sized from full-res first
    frames, pooled by INPUT geometry, checkpoints (analysis dims) load
    back with the x-k geometry peek."""
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, None, None, port=0, batch=1, downscale=2,
                     max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=3, h=16, w=32, seed=7)
        path = str(tmp_path / "sess.npz")
        with DiPsClient(srv.port) as cli:
            o, _ = cli.process(clip[0])
            assert o.shape == (8, 16, 3)
            cli.save(path)   # checkpoint at analysis dims (8, 16)
        # a fresh session restores from the checkpoint: the daemon must
        # size the engine from the peeked geometry x k
        with DiPsClient(srv.port) as cli2:
            fi = cli2.load(path)
            assert fi == 1
            o2, _ = cli2.process(clip[1])
            assert o2.shape == (8, 16, 3)
        with srv._pool_lock:
            assert list(srv._pool) == [(16, 32)]  # input-geometry keys
    finally:
        srv.shutdown()


def test_coalesced_mesh_row_sharded_sessions():
    """--coalesce-mesh SxR: coalesced slots on a 2-D (stream x rows)
    grid — the big-frame serving shape (VERDICT r4 item 5).  Two clients
    on a (2 x 4) grid must each get exactly what a dedicated
    single-stream engine computes (row sharding is pure layout)."""
    srv, props = coalesced_server(2, h=32, w=40, coalesce_mesh=(2, 4))
    try:
        clips = [make_clip(n=4, h=32, w=40, seed=80 + i) for i in range(2)]
        results = [None] * 2

        def run(i):
            cli = DiPsClient(srv.port)
            assert cli.hello()["config"]["coalesced"] is True
            assert cli.metrics()["coalesce_mesh"] == "2x4"
            outs, stats = [], []
            for f in clips[i]:
                o, s = cli.process(f)
                outs.append(o)
                stats.append(s)
            cli.close()
            results[i] = (np.stack(outs), np.stack(stats))

        ts = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        for i in range(2):
            assert results[i] is not None, f"client {i} did not finish"
            eng = DiPsEngine(props, 32, 40, batch=1)
            exp_out, exp_stats = eng.process_frames(list(clips[i]))
            np.testing.assert_array_equal(results[i][0], exp_out)
            np.testing.assert_allclose(results[i][1], exp_stats, atol=1e-6)
    finally:
        srv.shutdown()


def test_daemon_coalesce_mesh_flag_validation(capsys):
    """--coalesce-mesh parse errors and the --coalesce-devices conflict
    fail at startup, not at first request."""
    from dips_tpu_torch.serve.daemon import main as serve_main
    rc = serve_main(["--coalesce", "2", "--coalesce-mesh", "oops",
                     "--height", "32", "--width", "40"])
    assert rc == 2
    rc = serve_main(["--coalesce", "2", "--coalesce-mesh", "1x4",
                     "--coalesce-devices", "2",
                     "--height", "32", "--width", "40"])
    assert rc == 2
    # without --coalesce there are no slots to shard: fail at startup
    # instead of silently serving per-session on one chip
    rc = serve_main(["--coalesce-mesh", "1x4",
                     "--height", "32", "--width", "40"])
    assert rc == 2
    # non-positive axes are a parse error
    rc = serve_main(["--coalesce", "2", "--coalesce-mesh", "0x4",
                     "--height", "32", "--width", "40"])
    assert rc == 2


def test_flexible_daemon_coalesce_mesh():
    """A geometry-FLEXIBLE daemon with --coalesce-mesh builds each
    geometry's coalescer on the 2-D grid: a session sized from its first
    frame gets row-sharded slots and still matches a dedicated engine."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, port=0, batch=2, coalesce=2,
                     coalesce_mesh=(2, 4))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        clip = make_clip(n=4, h=32, w=40, seed=33)
        cli = DiPsClient(srv.port)
        outs = [cli.process(f)[0] for f in clip]
        cli.close()
        eng = DiPsEngine(props, 32, 40, batch=1)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()

