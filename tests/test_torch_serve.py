"""The port's serving daemon on the CPU: real socket round trips against
an in-process ``dips_tpu_torch.serve.DiPsServer`` (dedicated sessions, the
protocol, shutdown, resume, the resilient client, loadgen, roi, flicker,
downscale), each case of ``tests/test_serve.py`` with the port's engine as
the expectation.  Coalesced and flexible daemons:
``tests/test_torch_serve_coalesce.py``; autosave, events and the webhook:
``tests/test_torch_serve_state.py``; against the JAX package:
``tests/test_torch_serve_jax.py``."""

import threading

import numpy as np
import pytest
import torch

from dips_tpu_torch.properties import DiPsFilter, DiPsProperties
from dips_tpu_torch.serve import DiPsClient
from tests._torch_serve import (DiPsEngine, DiPsServer, blink_frames,
                                flexible_server)
from tests.conftest import make_clip

torch.set_num_threads(1)


@pytest.fixture()
def server():
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 24, 40, port=0, batch=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()


def test_serve_round_trip(server):
    clip = make_clip(n=6, h=24, w=40, seed=2)
    cli = DiPsClient(server.port)
    info = cli.hello()
    assert info["ok"] and info["config"]["height"] == 24

    outs, stats = [], []
    for f in clip:
        o, s = cli.process(f)
        outs.append(o)
        stats.append(s)
    cli.close()

    # must equal a local engine run frame-by-frame
    eng = DiPsEngine(DiPsProperties(window_size=3, temporal_size=2,
                                    filter=DiPsFilter.UNFILTERED),
                     24, 40, batch=1)
    exp_out, exp_stats = eng.process_frames(list(clip))
    np.testing.assert_array_equal(np.stack(outs), exp_out)
    np.testing.assert_allclose(np.stack(stats), exp_stats, atol=1e-6)


def test_serve_snapshot_and_heatmap(server):
    clip = make_clip(n=4, h=24, w=40, seed=3)
    cli = DiPsClient(server.port)
    for f in clip[:3]:
        cli.process(f)
    cli.snapshot()
    _, s = cli.process(clip[3])
    assert s[1] == 0  # forced re-capture -> zero diff
    hm = cli.heatmap()
    assert hm.shape == (24, 40) and hm.max() > 0
    cli.close()


def test_serve_bad_geometry_isolation(server):
    cli = DiPsClient(server.port)
    with pytest.raises(RuntimeError):
        cli.process(np.zeros((3, 3, 3), np.uint8))  # wrong geometry
    # the connection and engine survive the failed request
    o, _ = cli.process(make_clip(n=1, h=24, w=40)[0])
    assert o.shape == (24, 40, 3)
    cli.close()


def test_sequential_clients_share_state(server):
    """A reconnecting client continues the same stream (frame cursor and
    baseline persist across connections)."""
    clip = make_clip(n=4, h=24, w=40, seed=9)
    c1 = DiPsClient(server.port)
    c1.process(clip[0])
    c1.close()
    c2 = DiPsClient(server.port)
    info = c2.hello()
    assert info["frame_index"] == 1  # state survived the reconnect
    c2.process(clip[1])
    c2.close()


def test_serve_checkpoint_roundtrip(server, tmp_path):
    """save/load over the wire: a reloaded server continues bit-identically."""
    clip = make_clip(n=6, h=24, w=40, seed=5)
    path = str(tmp_path / "ckpt.npz")
    cli = DiPsClient(server.port)
    for f in clip[:3]:
        cli.process(f)
    cli.save(path)
    for f in clip[3:]:  # diverge the live state past the checkpoint
        cli.process(f)
    assert cli.load(path) == 3  # rewind
    outs = [cli.process(f)[0] for f in clip[3:]]
    cli.close()

    eng = DiPsEngine(DiPsProperties(window_size=3, temporal_size=2,
                                    filter=DiPsFilter.UNFILTERED),
                     24, 40, batch=1)
    eng.process_frames(list(clip[:3]))
    exp_out, _ = eng.process_frames(list(clip[3:]))
    np.testing.assert_array_equal(np.stack(outs), exp_out)


def test_serve_error_isolation(server):
    """A bad request errors that request, not the connection."""
    cli = DiPsClient(server.port)
    with pytest.raises(RuntimeError):
        cli.load("/nonexistent/nope.npz")
    out, stats = cli.process(make_clip(n=1, h=24, w=40)[0])
    assert out.shape == (24, 40, 3)
    cli.close()


def test_malformed_request_does_not_kill_daemon(server):
    """A garbage request must drop that connection only; the daemon keeps
    serving the next client (a regression)."""
    import socket
    import struct
    s = socket.create_connection(("127.0.0.1", server.port))
    s.sendall(struct.pack("<I", 12) + b"not json!!!!")
    s.close()
    # oversized header claim must be rejected, not allocated
    s2 = socket.create_connection(("127.0.0.1", server.port))
    s2.sendall(struct.pack("<I", 0xFFFFFFFF))
    s2.close()
    # daemon still alive and serving real work
    cli = DiPsClient(server.port)
    out, stats = cli.process(make_clip(n=1, h=24, w=40)[0])
    assert out.shape == (24, 40, 3)
    cli.close()


def test_shutdown_interrupts_idle_client():
    """shutdown() must stop the server even while a client sits idle in a
    connection (recv timeouts check the stop flag)."""
    import socket
    import time
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 8, 16, port=0, batch=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    idle = socket.create_connection(("127.0.0.1", srv.port))
    time.sleep(0.2)  # let the server enter _serve_client
    srv.shutdown()
    t.join(timeout=5.0)
    assert not t.is_alive()
    idle.close()


def test_signal_handler_shutdown_is_prompt_and_frees_port():
    """SIGTERM-style stop: the daemon installs a signal handler that calls
    shutdown(), and Python runs handlers ON the main thread — the very
    thread sitting in serve_forever's accept loop.  shutdown() must not
    wait for the accept loop to finish (it is suspended beneath the
    handler; the wait could only time out), and the port must be genuinely
    free once serve_forever returns."""
    import signal
    import socket
    import time
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 8, 16, port=0, batch=1)
    port = srv.port
    fired = []

    def _handler(signum, frame):
        fired.append(time.monotonic())
        srv.shutdown()

    old = signal.signal(signal.SIGALRM, _handler)
    try:
        signal.setitimer(signal.ITIMER_REAL, 0.3)
        t0 = time.monotonic()
        srv.serve_forever()  # returns once the handler stops it
        elapsed = time.monotonic() - t0
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)
    assert fired, "timer never fired"
    # pre-fix this stalled the full 5 s _accept_done timeout per stop
    assert elapsed < 3.0, f"signal-handler shutdown stalled {elapsed:.1f}s"
    # no SO_REUSEADDR here: the bind only succeeds if the port is
    # genuinely free, which is the fast-restart guarantee under test
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", port))
    finally:
        s.close()


def test_concurrent_sessions_have_independent_state(tmp_path):
    """Two clients on a 2-session server stream interleaved; each session's
    results match an independent single-stream engine run."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 10, 20, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clips = [make_clip(n=4, h=10, w=20, seed=s) for s in range(2)]
        clients = [DiPsClient(srv.port), DiPsClient(srv.port)]
        outs = {0: [], 1: []}
        for k in range(4):  # interleave frames across the two sessions
            for ci, cli in enumerate(clients):
                o, _ = cli.process(clips[ci][k])
                outs[ci].append(o)
        for ci, cli in enumerate(clients):
            cli.close()
            eng = DiPsEngine(props, 10, 20, batch=1)
            exp, _ = eng.process_frames(list(clips[ci]))
            np.testing.assert_array_equal(np.stack(outs[ci]), exp)
    finally:
        srv.shutdown()


def test_session_limit_rejects_extra_client():
    import socket as sk
    import struct
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 8, 16, port=0, batch=1, max_sessions=1)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        holder = DiPsClient(srv.port)   # occupies the only session
        holder.hello()
        extra = sk.create_connection(("127.0.0.1", srv.port))
        raw_len = extra.recv(4)
        n = struct.unpack("<I", raw_len)[0]
        import json as _json
        resp = _json.loads(extra.recv(n))
        assert not resp["ok"] and "session limit" in resp["error"]
        extra.close()
        holder.close()
    finally:
        srv.shutdown()


def test_process_batch_round_trip(server):
    """Batched requests equal per-frame requests frame-for-frame."""
    clip = make_clip(n=5, h=24, w=40, seed=7)
    c1 = DiPsClient(server.port)
    out_b, stats_b = c1.process_many(np.stack(clip))
    c1.close()
    eng = DiPsEngine(DiPsProperties(window_size=3, temporal_size=2,
                                    filter=DiPsFilter.UNFILTERED),
                     24, 40, batch=1)
    exp_out, exp_stats = eng.process_frames(list(clip))
    np.testing.assert_array_equal(out_b, exp_out)
    np.testing.assert_allclose(stats_b, exp_stats, atol=1e-6)


def test_protocol_fuzz_random_garbage(server):
    """Random byte blobs thrown at the daemon must never kill it."""
    import socket
    import struct
    rng = np.random.default_rng(0)
    for trial in range(12):
        s = socket.create_connection(("127.0.0.1", server.port))
        kind = trial % 4
        if kind == 0:      # random bytes, no framing
            s.sendall(bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
        elif kind == 1:    # valid length, garbage header
            s.sendall(struct.pack("<I", 32)
                      + bytes(rng.integers(0, 256, 32, dtype=np.uint8)))
        elif kind == 2:    # truncated mid-header
            s.sendall(struct.pack("<I", 1000) + b"{\"cmd\"")
        else:              # valid header, absurd payload claim
            hdr = b'{"cmd": "process", "payload_len": 999999999999}'
            s.sendall(struct.pack("<I", len(hdr)) + hdr)
        s.close()
    cli = DiPsClient(server.port)  # still alive
    assert cli.hello()["ok"]
    cli.close()


def test_multisession_anonymous_reconnect_gets_fresh_state():
    """On a multi-session server an untagged reconnect must NOT inherit a
    previous client's streaming state (baseline/cursor isolation)."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 10, 20, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=2, h=10, w=20, seed=1)
        a = DiPsClient(srv.port)
        a.process(clip[0])
        assert a.hello()["frame_index"] == 1
        a.close()
        b = DiPsClient(srv.port)  # must not resume A's engine
        assert b.hello()["frame_index"] == 0
        # frame 0 of a fresh stream re-captures the baseline: zero diff
        _, s = b.process(clip[1])
        assert s[1] == 0
        b.close()
    finally:
        srv.shutdown()


def test_single_session_anonymous_never_inherits_evicted_named_state():
    """A single-session daemon's anonymous resume exception covers only
    its own lone anonymous engine.  A NAMED session's engine that was
    evicted into the anonymous pool (named-session cap) must be reset
    before an anonymous client receives it — previously the client
    silently inherited the camera's baseline and frame cursor."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 10, 20, port=0, batch=1, max_sessions=1)
    srv.max_named_sessions = 1  # second named token evicts the first
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=2, h=10, w=20, seed=7)
        a = DiPsClient(srv.port, session="cam-A")
        a.process(clip[0])
        assert a.hello()["frame_index"] == 1
        a.close()                            # parks cam-A
        b = DiPsClient(srv.port, session="cam-B")
        b.process(clip[0])
        b.close()                            # parks cam-B, evicts cam-A
        anon = DiPsClient(srv.port)          # pops cam-A's pooled engine
        assert anon.hello()["frame_index"] == 0
        # frame 0 of a fresh stream re-captures the baseline: zero diff
        _, s = anon.process(clip[1])
        assert s[1] == 0
        anon.close()
    finally:
        srv.shutdown()


def test_named_session_resumes_across_reconnects():
    """A session token parks and resumes its engine on a multi-session
    server; a different token still gets fresh state."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 24, 40, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=4, h=24, w=40, seed=11)
        a1 = DiPsClient(srv.port, session="cam-A")
        outs = [a1.process(f)[0] for f in clip[:2]]
        a1.close()
        other = DiPsClient(srv.port, session="cam-B")
        assert other.hello()["frame_index"] == 0
        other.close()
        a2 = DiPsClient(srv.port, session="cam-A")
        assert a2.hello()["frame_index"] == 2  # resumed
        outs += [a2.process(f)[0] for f in clip[2:]]
        a2.close()
        eng = DiPsEngine(props, 24, 40, batch=1)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
    finally:
        srv.shutdown()


# -- coalesced serving: N sessions share one stacked-stream engine ----------


def test_metrics_command(server):
    clip = make_clip(n=3, h=24, w=40, seed=90)
    with DiPsClient(server.port) as cli:
        cli.process(clip[0])
        cli.process_many(clip[1:])
        with pytest.raises(RuntimeError):
            cli.load("/nonexistent/nope.npz")
        m = cli.metrics()
    assert m["frames"] == 3 and m["requests"] >= 4
    assert m["request_errors"] == 1 and m["active_sessions"] == 1
    assert m["connections"] == 1 and m["uptime_s"] >= 0
    assert m["coalesced"] is False and m["frame_index"] == 3
    lat = m["latency_ms"]
    assert lat["count"] == 2  # one process + one process_batch sample
    assert 0 <= lat["p50"] <= lat["p90"] <= lat["p99"] <= lat["max"]


def test_prometheus_metrics_endpoint():
    """--metrics-port serves Prometheus text format over HTTP."""
    import urllib.request
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, metrics_port=0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        assert srv.metrics_port
        with DiPsClient(srv.port) as cli:
            cli.process(make_clip(n=1, h=16, w=24)[0])
        url = f"http://127.0.0.1:{srv.metrics_port}/metrics"
        body = urllib.request.urlopen(url, timeout=10).read().decode()
        assert "# TYPE dips_requests counter" in body
        assert "dips_frames 1" in body
        assert 'dips_request_latency_ms{quantile="p50"}' in body
        with pytest.raises(Exception):  # non-metrics paths 404
            urllib.request.urlopen(
                f"http://127.0.0.1:{srv.metrics_port}/nope", timeout=10)
    finally:
        srv.shutdown()


def test_prometheus_single_type_line_per_family():
    """Duplicate # TYPE lines make Prometheus reject the whole scrape."""
    from dips_tpu_torch.serve import _prometheus_text

    text = _prometheus_text({
        "connections": 1, "flexible": True,
        "pooled_engines": {"16x24": 1, "32x48": 2}})
    assert text.count("# TYPE dips_pooled_engines gauge") == 1
    assert 'geometry="16x24"' in text and 'geometry="32x48"' in text


def test_resilient_client_reconnects_and_resends():
    """A connection killed BEFORE the request reaches the server: the
    client reconnects, resumes the parked session, and resends — the
    stream is bit-identical to an uninterrupted run."""
    from dips_tpu_torch.serve import ResilientDiPsClient

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        clip = make_clip(n=6, h=16, w=24, seed=4)
        c = ResilientDiPsClient(srv.port, session="cam", backoff_s=0.05)
        outs = [c.process(f)[0] for f in clip[:2]]
        c._cli._sock.close()  # dead link; request never sent
        outs += [c.process(f)[0] for f in clip[2:4]]  # reconnect + resend
        c._cli._sock.close()
        o_batch, _ = c.process_many(np.stack(clip[4:6]))
        outs += list(o_batch)
        c.close()

        eng = DiPsEngine(props, 16, 24, batch=2)
        exp, _ = eng.process_frames(list(clip))
        np.testing.assert_array_equal(np.stack(outs), exp)
        assert c.dropped_replies == 0
    finally:
        srv.shutdown()


def test_resilient_client_reply_lost_accounting():
    """A request processed by the server whose reply died on the wire:
    the client must NOT resend (double-processing) — it raises ReplyLost,
    records the drop, and the stream continues correctly aligned."""
    import time

    from dips_tpu_torch.errors import ReplyLost
    from dips_tpu_torch.serve import ResilientDiPsClient, _send

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        clip = make_clip(n=4, h=16, w=24, seed=5)
        c = ResilientDiPsClient(srv.port, session="cam", backoff_s=0.05)
        c.process(clip[0])
        # send frame 1 manually, then kill the connection before reading
        # the reply: the server processes it and parks the session
        payload = np.ascontiguousarray(clip[1]).tobytes()
        _send(c._cli._sock, {"cmd": "process",
                             "shape": list(clip[1].shape),
                             "session": "cam",
                             "payload_len": len(payload)}, payload)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:  # wait for the server cursor
            with srv._pool_lock:
                parked = "cam" in srv._named
            if parked:
                break
            time.sleep(0.02)
        c._cli._sock.close()
        time.sleep(0.1)
        with pytest.raises(ReplyLost):
            c.process(clip[1])
        assert c.dropped_replies == 1
        # the NEXT frame continues the stream exactly-once: server cursor
        # is 2 (frames 0 and 1), so frame 2 lands at index 2
        c.process(clip[2])
        assert c.hello()["frame_index"] == 3
        c.close()
    finally:
        srv.shutdown()


def test_resilient_client_survives_server_restart():
    """Daemon restart (session state gone): the client resumes fresh with
    a warning instead of erroring forever."""
    import time

    from dips_tpu_torch.serve import ResilientDiPsClient

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    port = srv.port
    clip = make_clip(n=4, h=16, w=24, seed=6)
    c = ResilientDiPsClient(port, session="cam", retries=8, backoff_s=0.1)
    c.process_many(np.stack(clip[:2]))
    srv.shutdown()
    srv2 = None
    for _ in range(50):  # the old listener can take a moment to release
        time.sleep(0.1)
        try:
            srv2 = DiPsServer(props, 16, 24, port=port, batch=2,
                              max_sessions=2)
            break
        except OSError:
            continue
    assert srv2 is not None, "could not rebind the port"
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        out, _ = c.process_many(np.stack(clip[2:4]))  # fresh resume
        assert out.shape == (2, 16, 24, 3)
        assert c.hello()["frame_index"] == 2  # new server: only these 2
        c.close()
    finally:
        srv2.shutdown()


def test_resilient_client_requires_session():
    from dips_tpu_torch.serve import ResilientDiPsClient

    with pytest.raises(ValueError, match="session"):
        ResilientDiPsClient(1234)


def test_resilient_client_initial_connect_backoff():
    """A camera that boots BEFORE the daemon is listening dials with
    backoff instead of dying at start-up (and still fails cleanly when
    nothing ever answers)."""
    import socket as sk
    import time

    from dips_tpu_torch.serve import ResilientDiPsClient

    # reserve a port the daemon will come up on shortly
    probe = sk.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    box = {}

    def late_start():
        time.sleep(0.4)
        for _ in range(50):  # TIME_WAIT on the probe can linger briefly
            try:
                box["srv"] = DiPsServer(props, 16, 24, port=port, batch=2,
                                        max_sessions=2)
                break
            except OSError:
                time.sleep(0.1)
        box["srv"].serve_forever()

    threading.Thread(target=late_start, daemon=True).start()
    c = ResilientDiPsClient(port, session="cam", retries=10, backoff_s=0.1)
    try:
        out, _ = c.process_many(np.stack(make_clip(n=2, h=16, w=24)))
        assert out.shape == (2, 16, 24, 3)
    finally:
        c.close()
        box["srv"].shutdown()

    # nothing listening at all: clean ConnectionError after the retries
    with pytest.raises(ConnectionError, match="could not connect"):
        ResilientDiPsClient(port, session="cam", retries=1,
                            backoff_s=0.01)


def test_loadgen_measures_daemon():
    from dips_tpu_torch.loadgen import parse_geometry, run_load

    assert parse_geometry("480p") == (480, 854)
    assert parse_geometry("32X48") == (32, 48)
    with pytest.raises(ValueError):
        parse_geometry("huge")

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=4)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        s = run_load(srv.port, clients=3, frames=4, height=16, width=24,
                     batch=2)
        assert s["ok"] and s["requests"] == 6 and s["frames"] == 12
        assert s["fps"] > 0 and s["latency_ms"]["p50"] > 0
        # wrong geometry surfaces as a clean error summary, not a hang
        bad = run_load(srv.port, clients=1, frames=2, height=8, width=8)
        assert not bad["ok"] and bad["errors"]
    finally:
        srv.shutdown()


def test_loadgen_rejects_unmeasurable_config():
    """frames < batch means zero measured requests per client: a clean
    error summary, not an IndexError on the empty percentile array (and
    no sockets are even opened)."""
    from dips_tpu_torch.loadgen import run_load

    s = run_load(1, clients=2, frames=1, batch=4)
    assert not s["ok"] and "zero measured" in s["errors"][0]
    s = run_load(1, clients=0, frames=4, batch=1)
    assert not s["ok"] and ">= 1" in s["errors"][0]


def test_loadgen_cli_json_line(capsys):
    from dips_tpu_torch.loadgen import main as lg_main

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        rc = lg_main(["--port", str(srv.port), "--clients", "2",
                      "--frames", "3", "--geometry", "16x24"])
        assert rc == 0
        import json as _json
        out = capsys.readouterr().out.strip()
        s = _json.loads(out)
        assert s["ok"] and s["frames"] == 6
    finally:
        srv.shutdown()


def test_link_health_counters():
    """link_drops and takeovers counters surface reconnect storms."""
    import socket as sk
    import struct
    import time

    srv, props = flexible_server()
    try:
        c1 = DiPsClient(srv.port, session="cam")
        c1.process(make_clip(n=1, h=16, w=24)[0])
        c1._sock.setsockopt(sk.SOL_SOCKET, sk.SO_LINGER,
                            struct.pack("ii", 1, 0))
        c1._sock.close()  # RST -> link_drops
        c2 = DiPsClient(srv.port, session="cam")
        c2.hello()        # may race the park -> takeover best-effort
        c2.process(make_clip(n=1, h=16, w=24)[0])
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            m = c2.metrics()
            if m["link_drops"] >= 1:
                break
            time.sleep(0.05)
        assert m["link_drops"] >= 1
        assert "takeovers" in m
        c2.close()
    finally:
        srv.shutdown()


def test_resilient_fleet_random_rst_stress():
    """8 resilient clients streaming concurrently with random abortive
    RSTs: every session's cursor must stay exactly-once consistent (the
    takeover + park/resume machinery under real contention)."""
    import random
    import socket as sk
    import struct

    from dips_tpu_torch.errors import ReplyLost
    from dips_tpu_torch.serve import ResilientDiPsClient

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=8)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    n_frames, n_clients = 12, 8
    results = {}
    failures = []

    def cam(k):
        rng = random.Random(k)
        frames = make_clip(n=n_frames, h=16, w=24, seed=k)
        try:
            c = ResilientDiPsClient(srv.port, session=f"s{k}",
                                    backoff_s=0.02, retries=8)
            done = 0
            for f in frames:
                if rng.random() < 0.25:  # abortive RST mid-stream
                    c._cli._sock.setsockopt(
                        sk.SOL_SOCKET, sk.SO_LINGER,
                        struct.pack("ii", 1, 0))
                    c._cli._sock.close()
                try:
                    c.process(f)
                except ReplyLost:
                    pass  # frame accounted server-side; output skipped
                done += 1
            fi = c.hello()["frame_index"]
            results[k] = (fi, done, c.dropped_replies)
            c.close()
        except Exception as e:
            failures.append(f"cam {k}: {e!r}")

    th = [threading.Thread(target=cam, args=(k,)) for k in range(n_clients)]
    for t in th:
        t.start()
    for t in th:
        t.join(timeout=60)
    try:
        assert not failures, failures
        assert len(results) == n_clients
        for k, (fi, done, dropped) in results.items():
            # exactly-once: server cursor equals frames submitted
            assert fi == done == n_frames, (k, fi, done, dropped)
    finally:
        srv.shutdown()


def test_per_session_roi():
    """Each session binds its own analysis region: stats normalize over
    the roi area, the quiet-region session reports ~no change, hello
    echoes the roi, and a parked named session refuses a different roi
    until reset."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 24, 40, port=0, batch=1, max_sessions=4)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=6, h=24, w=40, seed=2)  # square roams mid-frame
        roi_hot = (0, 0, 24, 40)
        roi_quiet = (0, 0, 2, 40)   # the moving square never enters
        with DiPsClient(srv.port, session="hot", roi=roi_hot) as hot, \
                DiPsClient(srv.port, session="quiet",
                           roi=roi_quiet) as quiet:
            assert hot.hello()["config"]["roi"] == list(roi_hot)
            assert quiet.hello()["config"]["roi"] == list(roi_quiet)
            s_hot, s_quiet = [], []
            for f in clip:
                _, sh = hot.process(f)
                _, sq = quiet.process(f)
                s_hot.append(sh)
                s_quiet.append(sq)
            s_hot, s_quiet = np.array(s_hot), np.array(s_quiet)
            # the quiet strip sees (almost) none of the square's motion
            assert s_hot[1:, 3].max() > 0
            assert s_quiet[1:, 3].max() <= s_hot[1:, 3].max() / 4
            # parity with an engine configured the same way
            eng = DiPsEngine(props.with_roi(roi_quiet), 24, 40, batch=1)
            _, exp = eng.process_frames(list(clip))
            np.testing.assert_allclose(s_quiet, exp, atol=1e-6)
        # a parked named session refuses to resume under a DIFFERENT roi
        with DiPsClient(srv.port, session="hot", roi=roi_quiet) as again:
            with pytest.raises(RuntimeError, match="parked with roi"):
                again.process(clip[0])
        # ...but resumes fine under the same one, state intact
        with DiPsClient(srv.port, session="hot", roi=roi_hot) as same:
            assert same.hello()["frame_index"] == len(clip)
        # a malformed roi is a per-request error, not a dropped connection
        with DiPsClient(srv.port) as bad:
            bad.roi = (1, 2, 3)
            with pytest.raises(RuntimeError, match="bad roi"):
                bad.process(clip[0])
            bad.roi = (0, 0, 99, 99)  # exceeds the daemon geometry
            with pytest.raises(RuntimeError, match="roi"):
                bad.process(clip[0])
    finally:
        srv.shutdown()


def test_roi_session_engine_never_pooled():
    """An anonymous roi'd session's engine must not re-surface for the
    next anonymous client (the pool's contract is the daemon's props)."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        f = np.zeros((16, 24, 3), np.uint8)
        with DiPsClient(srv.port, roi=(0, 0, 4, 4)) as a:
            a.process(f)
        with DiPsClient(srv.port) as b:  # plain anonymous session
            b.process(f)
            assert b.hello()["config"]["roi"] is None
        with srv._pool_lock:
            pooled = list(srv._pool)
        assert all(e.props.roi is None for e in pooled)
    finally:
        srv.shutdown()


def test_per_session_flicker():
    """Sessions opt into server-side flicker analysis; the map localizes
    the blinking region, parks/resumes with the named session, resets on
    reset, and parameter misuse is a per-request error."""
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=4)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        fps, hz = 24.0, 6.0
        frames = blink_frames(48, 16, 24, fps, hz)
        with DiPsClient(srv.port, session="cam", flicker_hz=hz,
                        flicker_fps=fps) as cli:
            for f in frames[:30]:
                cli.process(f)
            amp, meta = cli.flicker()
            assert meta["frames"] == 30 and meta["freq_hz"] == hz
            assert amp.shape == (16, 24)
        # parked + resumed: the window continues (frames accumulate)
        with DiPsClient(srv.port, session="cam", flicker_hz=hz,
                        flicker_fps=fps) as cli:
            for f in frames[30:]:
                cli.process(f)
            amp, meta = cli.flicker()
            assert meta["frames"] == len(frames)
            inside = amp[2:6, 3:9].mean()
            outside = np.delete(
                amp.reshape(-1),
                np.ravel_multi_index(np.mgrid[2:6, 3:9].reshape(2, -1),
                                     amp.shape)).mean()
            assert inside > 5 * outside, (inside, outside)
            # reset drops the window; the next request re-binds it fresh
            cli.reset()
            cli.process(frames[0])
            _, meta = cli.flicker()
            assert meta["frames"] == 1
            # a parameter change without reset is a per-request error
            cli.flicker_hz = 3.0
            with pytest.raises(RuntimeError, match="reset"):
                cli.process(frames[1])
        # misuse: fps without hz / no analyzer bound / hz over Nyquist
        with DiPsClient(srv.port) as c2:
            with pytest.raises(RuntimeError, match="flicker"):
                c2.flicker()
            c2.flicker_fps = 24.0
            with pytest.raises(RuntimeError, match="flicker_hz"):
                c2.process(frames[0])
        with DiPsClient(srv.port, flicker_hz=50.0,
                        flicker_fps=24.0) as c3:
            with pytest.raises(RuntimeError, match="resolvable"):
                c3.process(frames[0])
    finally:
        srv.shutdown()


def test_resilient_client_flicker_passthrough():
    """The fleet edge client rebinds the flicker window on reconnect."""
    from dips_tpu_torch.serve import ResilientDiPsClient
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, max_sessions=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        fps, hz = 24.0, 6.0
        frames = blink_frames(20, 16, 24, fps, hz)
        cli = ResilientDiPsClient(srv.port, session="edge",
                                  flicker_hz=hz, flicker_fps=fps,
                                  backoff_s=0.05)
        for f in frames[:10]:
            cli.process(f)
        # simulated dead link: the resilient client redials and the next
        # request re-binds the analyzer onto the resumed session
        cli._cli._sock.close()
        for f in frames[10:]:
            cli.process(f)
        amp, meta = cli._cli.flicker()
        assert meta["frames"] == len(frames)
        assert amp.shape == (16, 24)
    finally:
        srv.shutdown()


def test_serve_main_oversized_roi_is_friendly(capsys):
    """serve.main with an --roi larger than the fixed geometry: rc 2 +
    message, not a traceback out of DiPsServer.__init__."""
    from dips_tpu_torch.serve import main as serve_main
    rc = serve_main(["--height", "24", "--width", "40", "--port", "0",
                     "--roi", "0,0,99,99", "--device", "cpu"])
    assert rc == 2 and "roi" in capsys.readouterr().err


def test_serve_downscale_daemon():
    """A --downscale daemon accepts full-res frames and replies at the
    analysis geometry, matching a local downscale engine bit-for-bit;
    flexible + fixed modes and the pooled-engine geometry keys agree."""
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 32, 48, port=0, batch=2, downscale=2)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        clip = make_clip(n=4, h=32, w=48, seed=5)
        cli = DiPsClient(srv.port)
        info = cli.hello()
        cfg = info["config"]
        assert (cfg["height"], cfg["width"]) == (16, 24)
        assert (cfg["input_height"], cfg["input_width"]) == (32, 48)
        assert cfg["downscale"] == 2
        outs, stats = cli.process_many(np.stack(clip[:2]))
        assert outs.shape == (2, 16, 24, 3)
        o2, s2 = cli.process_many(np.stack(clip[2:]))
        cli.close()
        eng = DiPsEngine(props, 32, 48, batch=2, downscale=2)
        exp_out, exp_stats = eng.process_frames(list(clip))
        np.testing.assert_array_equal(
            np.concatenate([outs, o2]), exp_out)
        np.testing.assert_allclose(
            np.concatenate([stats, s2]), exp_stats, atol=1e-6)
    finally:
        srv.shutdown()



# ---------------------------------------------------------------------------
# the port's daemon process, and its default device
# ---------------------------------------------------------------------------

def test_daemon_process_serves_and_stops_on_sigterm():
    """``python -m dips_tpu_torch.serve --device cpu``: the daemon prints
    its port, serves a frame as an engine of the same flags computes it,
    and a SIGTERM stops it with exit code 0."""
    import signal
    import subprocess
    import sys

    from dips_tpu_torch.cli import build_parser, props_from_args
    proc = subprocess.Popen(
        [sys.executable, "-m", "dips_tpu_torch.serve", "--device", "cpu",
         "--port", "0", "--height", "16", "--width", "24", "--batch", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("dips server on 127.0.0.1:"), (
            line, proc.stderr.read() if proc.poll() is not None else "")
        port = int(line.rsplit(":", 1)[1])
        clip = make_clip(n=3, h=16, w=24, seed=4)
        with DiPsClient(port) as cli:
            assert cli.hello()["config"]["backend"] == "plain"
            maps, stats = cli.process_many(clip)
        eng = DiPsEngine(props_from_args(build_parser().parse_args([])),
                         16, 24, batch=2)
        exp_maps, exp_stats = eng.process_frames(list(clip))
        np.testing.assert_array_equal(maps, exp_maps)
        np.testing.assert_array_equal(stats, exp_stats)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


@pytest.mark.parametrize("argv", [[], ["--device", "cuda"],
                                  ["--coalesce", "2"]])
def test_daemon_without_a_card_fails(argv, capsys):
    """No ``--device cpu`` and no card: exit 1 with the DeviceError's
    message, as the run CLI does."""
    from dips_tpu_torch.serve import main as serve_main
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = serve_main(["--port", "0", "--height", "16", "--width", "24"]
                    + argv)
    assert rc == 1 and "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("kw", [dict(height=16, width=24), dict(),
                                dict(height=16, width=24, coalesce=2),
                                dict(coalesce=2)],
                         ids=["fixed", "flexible", "coalesced",
                              "flexible_coalesced"])
def test_server_defaults_to_the_card(kw):
    """Every server kind raises DeviceError without a card unless "cpu"
    is asked for, before it binds a port."""
    from dips_tpu_torch import DeviceError
    from dips_tpu_torch.serve import DiPsServer as CardServer
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceError):
        CardServer(DiPsProperties(), port=0, **kw)


def test_daemon_process_without_a_card_exits_1():
    import subprocess
    import sys
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run(
        [sys.executable, "-m", "dips_tpu_torch.serve", "--port", "0",
         "--height", "16", "--width", "24"],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 1 and "no CUDA device" in res.stderr
    assert res.stdout == ""


def test_slow_reader_still_gets_a_large_reply(monkeypatch):
    """A reply larger than the socket buffers drains into a client that
    starts reading after the idle poll's 0.5 s and then reads slowly, so
    that the whole send lasts several times the stalled-message deadline
    (cut here to 1 s) while every gap stays under it: the deadline counts
    from the last byte sent, never from the start of the send.  (Python's
    sendall timeout bounds the whole send; under the 0.5 s poll the JAX
    server's reply of a 1080p batch fails and the client's stream
    desyncs.)"""
    import json
    import socket
    import time

    import dips_tpu_torch.serve.server as server_mod
    from dips_tpu_torch.properties import OutputMode
    from dips_tpu_torch.serve import _recv, _send
    from dips_tpu_torch.serve.protocol import _LEN
    stall = 1.0
    monkeypatch.setattr(server_mod, "_PARTIAL_TIMEOUT_S", stall)
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=1)
    h, w, n = 256, 1024, 16  # 12.6 MB of maps: more than the buffers hold
    srv = DiPsServer(props, h, w, port=0, batch=n)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        clip = make_clip(n=n, h=h, w=w, seed=1)
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s.connect(("127.0.0.1", srv.port))
        s.settimeout(30)  # a lost reply fails the test, never hangs it
        payload = clip.tobytes()
        _send(s, {"cmd": "process_batch", "shape": list(clip.shape),
                  "payload_len": len(payload)}, payload)
        time.sleep(0.75)  # a busy client: the reply waits to drain
        # then a reader paced to 4 MB/s: 3 s for the maps, in gaps of
        # 16 ms at most
        rate, raw = 4e6, bytearray()
        t0 = time.monotonic()
        while True:
            chunk = s.recv(1 << 16)
            if not chunk:
                break
            raw += chunk
            if len(raw) >= _LEN.size:
                hlen = _LEN.unpack_from(raw)[0]
                if len(raw) >= _LEN.size + hlen:
                    hdr = json.loads(raw[_LEN.size:_LEN.size + hlen])
                    if len(raw) >= _LEN.size + hlen + hdr["payload_len"]:
                        break
            time.sleep(max(0.0, t0 + len(raw) / rate - time.monotonic()))
        paced = time.monotonic() - t0
        body = bytes(raw[_LEN.size + hlen:])
        assert hdr["ok"], hdr
        assert paced > 2.5 * stall  # the send outlasted the deadline
        exp, _ = DiPsEngine(props, h, w, batch=n).process_frames(list(clip))
        np.testing.assert_array_equal(
            np.frombuffer(body, np.uint8).reshape(exp.shape), exp)
        # the stream stays in step: the next request gets its own reply
        _send(s, {"cmd": "hello"})
        assert _recv(s)[0]["ok"]
        s.close()
        assert srv.metrics()["request_errors"] == 0
    finally:
        srv.shutdown()


def test_stalled_reader_is_dropped_not_desynced(monkeypatch):
    """A client that stops reading for longer than the stalled-message
    deadline loses its connection: it reads what the buffers held, then
    the end of the stream, and no error message follows the cut reply."""
    import socket
    import time

    import dips_tpu_torch.serve.server as server_mod
    from dips_tpu_torch.properties import OutputMode
    from dips_tpu_torch.serve import _send
    monkeypatch.setattr(server_mod, "_PARTIAL_TIMEOUT_S", 0.5)
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=1)
    h, w, n = 256, 1024, 16
    srv = DiPsServer(props, h, w, port=0, batch=n)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        clip = make_clip(n=n, h=h, w=w, seed=1)
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        s.connect(("127.0.0.1", srv.port))
        s.settimeout(30)
        payload = clip.tobytes()
        _send(s, {"cmd": "process_batch", "shape": list(clip.shape),
                  "payload_len": len(payload)}, payload)
        deadline = time.monotonic() + 30
        while srv.metrics()["request_errors"] < 1:
            assert time.monotonic() < deadline, "the stall was not cut"
            time.sleep(0.05)
        raw = bytearray()
        while True:
            try:
                chunk = s.recv(1 << 16)
            except ConnectionResetError:
                break
            if not chunk:
                break
            raw += chunk
        s.close()
        assert 0 < len(raw) < n * h * w * 3  # a cut reply, then the end
        assert b'"error"' not in bytes(raw[-4096:])
    finally:
        srv.shutdown()
