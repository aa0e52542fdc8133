"""The port's daemon state on the CPU: autosave crash recovery (restart,
flexible pre-bind hello, close flush, reset discard, coalesced slots,
corrupt files, tmp names and sweep), motion events over the serving
stats, and the motion-event webhook (``utils/webhook.WebhookSender`` and
``--event-webhook`` against an in-process HTTP receiver on localhost);
each case of ``tests/test_serve.py`` and ``tests/test_webhook.py`` with
the port's engine as the expectation."""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import torch

from dips_tpu_torch.properties import DiPsFilter, DiPsProperties
from dips_tpu_torch.serve import DiPsClient
from dips_tpu_torch.utils.webhook import WebhookSender
from tests._torch_serve import (DiPsEngine, DiPsServer, absdiff_props,
                                event_clip, event_server, flexible_server,
                                wait_autosaves)
from tests.conftest import make_clip

torch.set_num_threads(1)


def test_autosave_restores_after_daemon_restart(tmp_path):
    """A daemon crash between autosaves loses at most the unsaved tail:
    the restarted daemon restores the session from disk, and the
    continued stream is BIT-IDENTICAL to one uninterrupted engine."""
    props = absdiff_props()
    clip = make_clip(n=6, h=16, w=24, seed=11)

    ref = DiPsEngine(props, 16, 24, batch=2)
    exp_out, exp_stats = ref.process_frames(list(clip))

    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2,
                     autosave_dir=str(tmp_path), autosave_every=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    c = DiPsClient(srv.port, session="cam")
    out_a1, stats_a1 = c.process_many(np.stack(clip[:2]))
    out_a2, stats_a2 = c.process_many(np.stack(clip[2:4]))
    out_a = np.concatenate([out_a1, out_a2])
    stats_a = np.concatenate([stats_a1, stats_a2])
    # one autosave per 2-frame request; "crash" without close
    wait_autosaves(srv, 2)
    srv.shutdown()

    srv2 = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2,
                      autosave_dir=str(tmp_path), autosave_every=2)
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 4  # restored, not fresh
        out_b, stats_b = c2.process_many(np.stack(clip[4:6]))
        np.testing.assert_array_equal(
            np.concatenate([out_a, out_b]), exp_out)
        np.testing.assert_allclose(
            np.concatenate([stats_a, stats_b]), exp_stats,
            atol=1e-5, rtol=1e-5)
        assert srv2.metrics()["autorestores"] == 1
        c2.close()
    finally:
        srv2.shutdown()


def test_autosave_flexible_prebind_hello_reports_restored_cursor(tmp_path):
    """Flexible daemon restart: a pre-bind hello with a token recovers
    geometry from the autosave and reports the restored cursor (0 would
    make a resilient client wrongly resume fresh)."""
    srv, props = flexible_server(autosave_dir=str(tmp_path),
                                  autosave_every=2)
    clip = make_clip(n=4, h=16, w=24, seed=3)
    c = DiPsClient(srv.port, session="cam")
    c.process_many(np.stack(clip))
    wait_autosaves(srv, 1)
    srv.shutdown()

    srv2, _ = flexible_server(autosave_dir=str(tmp_path),
                               autosave_every=2)
    try:
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 4  # pre-bind, geometry peeked
        out, _ = c2.process_many(np.stack(clip))
        assert out.shape == (4, 16, 24, 3)
        c2.close()
    finally:
        srv2.shutdown()


def test_autosave_close_flushes_and_reset_discards(tmp_path):
    """A graceful close flushes the unsaved tail even below the interval;
    an explicit reset discards the checkpoint (a restart must not
    resurrect state the client threw away)."""
    import os

    props = absdiff_props()
    clip = make_clip(n=3, h=16, w=24, seed=5)
    srv = DiPsServer(props, 16, 24, port=0, batch=3, max_sessions=2,
                     autosave_dir=str(tmp_path), autosave_every=100)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    c = DiPsClient(srv.port, session="cam")
    c.process_many(np.stack(clip))
    c.close()  # interval not reached: the close flushes
    path = srv._autosave_path("cam")
    assert os.path.exists(path)
    srv.shutdown()

    srv2 = DiPsServer(props, 16, 24, port=0, batch=3, max_sessions=2,
                      autosave_dir=str(tmp_path), autosave_every=100)
    threading.Thread(target=srv2.serve_forever, daemon=True).start()
    try:
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 3
        c2.reset()
        assert not os.path.exists(path)  # checkpoint discarded with state
        assert c2.hello()["frame_index"] == 0
        c2.close()
        # close after reset with zero new frames must not resurrect a file
        assert not os.path.exists(path)
    finally:
        srv2.shutdown()


def test_autosave_coalesced_slot_roundtrip(tmp_path):
    """Coalesced daemons autosave per-slot state through the same
    DiPsEngine-compatible checkpoints; a restarted coalesced daemon
    restores the slot."""
    srv, props = flexible_server(coalesce=2, autosave_dir=str(tmp_path),
                                  autosave_every=2)
    clip = make_clip(n=4, h=16, w=24, seed=9)
    c = DiPsClient(srv.port, session="cam")
    c.process_many(np.stack(clip))
    wait_autosaves(srv, 1)
    srv.shutdown()

    srv2, _ = flexible_server(coalesce=2, autosave_dir=str(tmp_path),
                               autosave_every=2)
    try:
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 4
        out, _ = c2.process_many(np.stack(clip))
        assert out.shape == (4, 16, 24, 3)
        assert srv2.metrics()["autorestores"] == 1
        c2.close()
    finally:
        srv2.shutdown()


def test_autosave_off_by_default(tmp_path):
    """Without autosave_dir nothing is written and counters stay zero."""
    props = absdiff_props()
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = DiPsClient(srv.port, session="cam")
        c.process_many(np.stack(make_clip(n=2, h=16, w=24)))
        c.close()
        m = srv.metrics()
        assert m["autosaves"] == 0 and m["autorestores"] == 0
    finally:
        srv.shutdown()


def test_autosave_corrupt_file_reads_as_fresh(tmp_path):
    """Regression: a corrupt autosave .npz (disk damage, torn write)
    must NOT brick the token — the pre-bind hello answers fresh and the
    first processed frames overwrite the bad checkpoint."""
    import os

    srv, _ = flexible_server(autosave_dir=str(tmp_path), autosave_every=2)
    bad = srv._autosave_path("cam")
    with open(bad, "wb") as f:
        f.write(b"not a zipfile at all")
    try:
        c = DiPsClient(srv.port, session="cam")
        assert c.hello()["frame_index"] == 0  # fresh, not an error
        clip = make_clip(n=2, h=16, w=24, seed=21)
        out, _ = c.process_many(np.stack(clip))
        assert out.shape[0] == 2
        wait_autosaves(srv, 1)  # the good state replaced the corrupt file
        with np.load(bad) as z:
            assert "geometry" in z.files
        c.close()
    finally:
        srv.shutdown()


def test_autosave_token_named_dot_tmp_not_clobbered(tmp_path):
    """Regression: the old fixed tmp-file scheme made session
    'cam''s autosave tmp path equal session 'cam.tmp''s checkpoint path,
    deterministically deleting the latter on every autosave of the
    former."""
    import os

    props = absdiff_props()
    clip = make_clip(n=2, h=16, w=24, seed=23)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2,
                     autosave_dir=str(tmp_path), autosave_every=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c_tmp = DiPsClient(srv.port, session="cam.tmp")
        c_tmp.process_many(np.stack(clip))
        c_tmp.close()
        c = DiPsClient(srv.port, session="cam")
        c.process_many(np.stack(clip))
        c.close()
        assert os.path.exists(srv._autosave_path("cam"))
        assert os.path.exists(srv._autosave_path("cam.tmp"))
        # and no orphaned tmp litter remains after clean writes
        import glob as _glob
        assert not _glob.glob(str(tmp_path / "*#tmp#*"))
    finally:
        srv.shutdown()


def test_autosave_prebind_metrics_and_close_stay_bindfree(tmp_path):
    """Regression: a monitoring scrape (metrics) or teardown
    (close) with an unbound token must not trigger checkpoint IO, an
    engine build, or a restore on a flexible daemon."""
    srv, _ = flexible_server(autosave_dir=str(tmp_path), autosave_every=2)
    clip = make_clip(n=2, h=16, w=24, seed=25)
    c = DiPsClient(srv.port, session="cam")
    c.process_many(np.stack(clip))
    wait_autosaves(srv, 1)
    srv.shutdown()

    srv2, _ = flexible_server(autosave_dir=str(tmp_path), autosave_every=2)
    try:
        m = DiPsClient(srv2.port, session="cam")
        assert m.metrics()["ok"]
        m.close()
        assert srv2.metrics()["autorestores"] == 0  # stayed bind-free
        # a real hello still restores
        c2 = DiPsClient(srv2.port, session="cam")
        assert c2.hello()["frame_index"] == 2
        c2.close()
        assert srv2.metrics()["autorestores"] == 1
    finally:
        srv2.shutdown()


def test_autosave_due_counter_not_recycled_with_pooled_engine(tmp_path):
    """Regression: an engine returned to the anonymous pool with
    unsaved frames on its counter must not hand that counter to the next
    session that binds it (premature / frame-0 checkpoints)."""
    props = absdiff_props()
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2,
                     autosave_dir=str(tmp_path), autosave_every=100)
    try:
        eng = srv._bind_engine(None)
        eng._autosave_due = 7  # unsaved tail from a previous life
        srv._release_engine(eng)
        eng2 = srv._bind_engine("fresh-token")
        assert eng2 is eng  # pooled engine recycled...
        assert getattr(eng2, "_autosave_due", 0) == 0  # ...counter cleared
    finally:
        srv.shutdown()


def test_serve_events_annotate_replies_and_metrics():
    srv = event_server()
    clip = event_clip()
    try:
        c = DiPsClient(srv.port, session="cam")
        c.process_many(clip[:4])          # static: nothing
        assert c.last_events == [] and not c.event_open
        c.process_many(clip[4:8])         # motion begins: event opens
        assert c.event_open and c.last_events == []
        all_events = []
        c.process_many(clip[8:12])        # motion ends inside this batch
        all_events += c.last_events
        c.process_many(clip[12:14])       # fully static
        all_events += c.last_events
        assert all_events, "event never closed"
        e = all_events[0]
        assert e["start_frame"] == 4 and 9 <= e["end_frame"] <= 10
        assert not c.event_open
        assert srv.metrics()["motion_events"] == 1
        c.close()
    finally:
        srv.shutdown()


def test_serve_events_survive_park_resume_and_reset_clears():
    """A NAMED session's open event survives a reconnect (park/resume);
    an explicit reset discards it."""
    srv = event_server()
    clip = event_clip()
    try:
        c = DiPsClient(srv.port, session="cam")
        c.process_many(clip[:8])          # event open at disconnect
        assert c.event_open
        c.close()                          # named: parks WITHOUT flushing
        c2 = DiPsClient(srv.port, session="cam")
        closed = []
        c2.process_many(clip[8:12])        # resumes the SAME open event
        closed += c2.last_events
        c2.process_many(clip[12:14])
        closed += c2.last_events
        assert closed and closed[0]["start_frame"] == 4  # spans the park
        c2.reset()
        c2.process_many(clip[:4])          # fresh segmentation after reset
        assert c2.last_events == [] and not c2.event_open
        c2.close()
    finally:
        srv.shutdown()


def test_serve_events_anonymous_close_flushes():
    srv = event_server()
    clip = event_clip()
    try:
        c = DiPsClient(srv.port)           # anonymous
        c.process_many(clip[:8])
        assert c.event_open
        c.close()                          # end of stream: flush
        assert c.last_events and c.last_events[0]["start_frame"] == 4
        assert srv.metrics()["motion_events"] == 1
    finally:
        srv.shutdown()


def test_serve_events_off_by_default():
    props = DiPsProperties(window_size=1, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, 16, 24, port=0, batch=2, max_sessions=2)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        c = DiPsClient(srv.port, session="cam")
        c.process_many(np.stack(make_clip(n=2, h=16, w=24)))
        assert c.last_events == [] and not c.event_open
        assert srv.metrics()["motion_events"] == 0
        c.close()
    finally:
        srv.shutdown()


def test_serve_events_coalesced_per_slot():
    """Coalesced daemon: each slot segments ITS OWN stream — one moving
    camera must not open events on an idle sibling."""
    from dips_tpu_torch.properties import OutputMode
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    srv = DiPsServer(props, 16, 24, port=0, batch=1, coalesce=2,
                     events=dict(on_threshold=0.02, metric="changed_frac",
                                 min_frames=2))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    clip = event_clip()
    static = make_clip(n=14, h=16, w=24, seed=3, moving=False)
    try:
        a = DiPsClient(srv.port, session="moving-cam")
        b = DiPsClient(srv.port, session="idle-cam")
        opened = False
        for i in range(14):
            a.process(clip[i])
            opened = opened or a.event_open
            b.process(static[i])
            assert not b.event_open and b.last_events == []
        assert opened
        a.close(); b.close()
        assert srv.metrics()["motion_events"] >= 1
    finally:
        srv.shutdown()


def test_serve_events_resilient_client_passthrough():
    """ResilientDiPsClient surfaces event annotations and an open event
    survives its reconnect (the parked session carries the detector)."""
    from dips_tpu_torch.serve import ResilientDiPsClient
    from dips_tpu_torch.errors import ReplyLost
    srv = event_server()
    clip = event_clip()
    try:
        c = ResilientDiPsClient(srv.port, session="cam", retries=3,
                                backoff_s=0.05)
        c.process_many(clip[:8])
        assert c.event_open and c.last_events == []
        # dead link mid-event: reconnect resumes the same open event
        c._cli._sock.close()
        closed = []
        try:
            c.process_many(clip[8:12])
        except ReplyLost:
            pass
        closed += c.last_events
        c.process_many(clip[12:14])
        closed += c.last_events
        assert closed and closed[0]["start_frame"] == 4
        c.close()
    finally:
        srv.shutdown()


def test_combined_feature_stress_events_autosave_restart(tmp_path):
    """The full production stack at once: an --events + --autosave daemon
    serving resilient clients under random RSTs, then a daemon CRASH and
    restart mid-fleet.  Every cursor must stay exactly-once consistent,
    every camera's motion must be flagged, and restored sessions must
    resume their autosaved cursor (never fresh)."""
    import random
    import socket as sk
    import struct

    from dips_tpu_torch.errors import ReplyLost
    from dips_tpu_torch.properties import OutputMode
    from dips_tpu_torch.serve import ResilientDiPsClient

    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)

    def start(port=0):
        s = DiPsServer(props, 16, 24, port=port, batch=2, max_sessions=6,
                       autosave_dir=str(tmp_path), autosave_every=2,
                       events=dict(on_threshold=0.02,
                                   metric="changed_frac", min_frames=2))
        threading.Thread(target=s.serve_forever, daemon=True).start()
        return s

    srv = start()
    port = srv.port
    n_clients, n_frames = 6, 16
    restart_gate = threading.Barrier(n_clients + 1)
    results, failures = {}, []

    def cam(k):
        rng = random.Random(100 + k)
        clip = np.concatenate([
            make_clip(n=6, h=16, w=24, seed=k, moving=False),
            make_clip(n=6, h=16, w=24, seed=k, moving=True),
            make_clip(n=4, h=16, w=24, seed=k, moving=False)])
        try:
            c = ResilientDiPsClient(port, session=f"cam{k}",
                                    backoff_s=0.05, retries=20)
            saw_motion, done = False, 0
            for i, f in enumerate(clip):
                if i == 8:
                    restart_gate.wait(timeout=60)  # daemon crash point
                if rng.random() < 0.2:
                    c._cli._sock.setsockopt(
                        sk.SOL_SOCKET, sk.SO_LINGER,
                        struct.pack("ii", 1, 0))
                    c._cli._sock.close()
                try:
                    c.process(f)
                    saw_motion = saw_motion or c.event_open or bool(
                        c.last_events)
                except ReplyLost:
                    pass  # accounted server-side
                done += 1
            fi = c.hello()["frame_index"]
            results[k] = (fi, done, saw_motion)
            c.close()
        except Exception as e:
            failures.append(f"cam {k}: {e!r}")

    th = [threading.Thread(target=cam, args=(k,))
          for k in range(n_clients)]
    for t in th:
        t.start()
    restart_gate.wait(timeout=60)
    # simulate a crash: no graceful close of parked/live sessions
    srv.shutdown()
    srv2 = start(port=port)  # same port: the fleet's reconnects land here
    for t in th:
        t.join(timeout=120)
    try:
        assert not failures, failures
        assert len(results) == n_clients
        for k, (fi, done, saw_motion) in results.items():
            assert done == n_frames, (k, results[k])
            # crash semantics: the restart restores the last autosave, so
            # a session may lose at most autosave_every(=2) frames of
            # cursor (never more, never resumes fresh at 0)
            assert n_frames - 2 <= fi <= n_frames, (k, results[k])
            assert saw_motion, f"cam{k} never saw its motion flagged"
        m = srv2.metrics()
        assert m["autorestores"] >= 1  # the restart restored from disk
    finally:
        srv2.shutdown()


def test_autosave_tmp_sweep_spares_inflight_files(tmp_path):
    """Startup sweeps only OLD orphaned tmp files: a fast restart must
    not delete the previous daemon's in-flight autosave tmp."""
    import os
    import time as _time

    old = tmp_path / "cam.#tmp#aaaa.npz"
    fresh = tmp_path / "cam.#tmp#bbbb.npz"
    for p in (old, fresh):
        p.write_bytes(b"x")
    past = _time.time() - 300
    os.utime(old, (past, past))
    srv = DiPsServer(absdiff_props(), 16, 24, port=0,
                     autosave_dir=str(tmp_path))
    try:
        assert not old.exists()    # orphan from a crash: swept
        assert fresh.exists()      # possibly in-flight: spared
    finally:
        srv.shutdown()


# ---------------------------------------------------------------------------
# the motion-event webhook (tests/test_webhook.py)
# ---------------------------------------------------------------------------

class _Receiver:
    """Minimal threaded HTTP receiver recording every JSON POST body.

    ``status`` can be changed mid-test to simulate a failing endpoint.
    """

    def __init__(self, status=200):
        self.bodies = []
        self.hits = 0
        self.status = status
        recv = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — http.server API
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                recv.hits += 1
                if 200 <= recv.status < 300:
                    recv.bodies.append(json.loads(raw))
                self.send_response(recv.status)
                self.end_headers()

            def log_message(self, *a):  # silence stderr chatter
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_port}/alerts"
        threading.Thread(target=self.httpd.serve_forever,
                         daemon=True).start()

    def wait(self, n, timeout=5.0, attr="bodies"):
        deadline = time.time() + timeout
        while time.time() < deadline:
            got = getattr(self, attr)
            cur = got if isinstance(got, int) else len(got)
            if cur >= n:
                return
            time.sleep(0.01)
        raise AssertionError(
            f"receiver saw {getattr(self, attr)} after {timeout}s, "
            f"wanted {n} {attr}")

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture()
def receiver():
    r = _Receiver()
    yield r
    r.close()


# ---------------------------------------------------------------------------
# WebhookSender unit behavior
# ---------------------------------------------------------------------------

def test_sender_delivers_json(receiver):
    outcomes = []
    s = WebhookSender(receiver.url, on_result=outcomes.append)
    assert s.post({"hello": 1})
    receiver.wait(1)
    s.close()
    assert receiver.bodies == [{"hello": 1}]
    assert outcomes == ["delivered"]


def test_sender_rejects_non_http_url():
    with pytest.raises(ValueError, match="http"):
        WebhookSender("ftp://example.com/x")
    with pytest.raises(ValueError, match="http"):
        WebhookSender("/not/a/url")


def test_sender_retries_then_counts_failed():
    recv = _Receiver(status=500)
    outcomes = []
    try:
        s = WebhookSender(recv.url, retries=2, backoff_s=0.01,
                          timeout_s=2.0, on_result=outcomes.append)
        s.post({"x": 1})
        recv.wait(3, attr="hits")          # initial try + 2 retries
        s.close()
        assert recv.hits == 3
        assert outcomes == ["failed"]
    finally:
        recv.close()


def test_sender_recovers_midway_through_retries():
    recv = _Receiver(status=503)
    outcomes = []
    try:
        s = WebhookSender(recv.url, retries=3, backoff_s=0.05,
                          timeout_s=2.0, on_result=outcomes.append)
        s.post({"x": 2})
        recv.wait(1, attr="hits")
        recv.status = 200                  # endpoint comes back
        recv.wait(1)                       # a retry lands the body
        s.close()
        assert outcomes == ["delivered"]
        assert recv.bodies == [{"x": 2}]
    finally:
        recv.close()


def test_sender_unreachable_host_counts_failed():
    outcomes = []
    # bind-then-close: the port is guaranteed closed now
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    s = WebhookSender(f"http://127.0.0.1:{port}/x", retries=1,
                      backoff_s=0.01, timeout_s=0.5,
                      on_result=outcomes.append)
    s.post({"x": 3})
    deadline = time.time() + 5
    while not outcomes and time.time() < deadline:
        time.sleep(0.01)
    s.close()
    assert outcomes == ["failed"]


def test_sender_bounded_queue_drops_and_counts(receiver):
    outcomes = []
    s = WebhookSender(receiver.url, queue_max=1, on_result=outcomes.append)
    # stall the worker so the queue stays full: post a payload to a slow
    # endpoint first?  Simpler: close the worker's view by flooding faster
    # than one tiny HTTP round-trip can drain.
    dropped = 0
    for i in range(200):
        if not s.post({"i": i}):
            dropped += 1
    s.close(flush_timeout_s=5.0)
    assert dropped >= 1
    assert outcomes.count("dropped") == dropped
    # everything not dropped was eventually delivered or failed, no limbo
    assert outcomes.count("delivered") + outcomes.count("failed") \
        == 200 - dropped


def test_sender_post_after_close_drops(receiver):
    outcomes = []
    s = WebhookSender(receiver.url, on_result=outcomes.append)
    s.close()
    assert not s.post({"late": True})
    assert outcomes == ["dropped"]


def test_sender_close_flushes_backlog(receiver):
    s = WebhookSender(receiver.url)
    for i in range(8):
        s.post({"i": i})
    s.close(flush_timeout_s=10.0)
    assert [b["i"] for b in receiver.bodies] == list(range(8))


def test_sender_close_does_not_hang_on_dead_receiver():
    """A dead endpoint must not hold close() past its flush timeout."""
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    outcomes = []
    s = WebhookSender(f"http://127.0.0.1:{port}/x", retries=5,
                      backoff_s=0.5, timeout_s=5.0,
                      on_result=outcomes.append)
    for i in range(50):
        s.post({"i": i})
    t0 = time.time()
    s.close(flush_timeout_s=0.5)
    assert time.time() - t0 < 3.0
    # close() must also STOP the worker: no retry backoffs or deliveries
    # may outlive it (they used to log warnings minutes after shutdown).
    deadline = time.time() + 2.0
    while s._thread.is_alive() and time.time() < deadline:
        time.sleep(0.02)
    assert not s._thread.is_alive()
    # every queued alert reached a terminal outcome — failed (connection
    # refused is instant) or dropped at abort — none left in limbo.
    assert outcomes.count("failed") + outcomes.count("dropped") == 50


# ---------------------------------------------------------------------------
# serve.py integration (--events --event-webhook)
# ---------------------------------------------------------------------------

def test_serve_webhook_posts_closed_events(receiver):
    srv = event_server(event_webhook=receiver.url)
    clip = event_clip()
    try:
        c = DiPsClient(srv.port, session="cam")
        for i in range(0, 14, 4):
            c.process_many(clip[i:i + 4])
        receiver.wait(1)
        c.close()
        alert = receiver.bodies[0]
        assert alert["type"] == "motion_event"
        assert alert["session"] == "cam"
        assert alert["geometry"] == "16x24"
        assert alert["port"] == srv.port
        assert alert["event"]["start_frame"] == 4
        assert 9 <= alert["event"]["end_frame"] <= 10
        # webhook delivery outcome surfaces in the daemon metrics
        deadline = time.time() + 5
        while srv.metrics()["webhook_delivered"] < 1 \
                and time.time() < deadline:
            time.sleep(0.01)
        m = srv.metrics()
        assert m["webhook_delivered"] == 1
        assert m["webhook_failed"] == 0 and m["webhook_dropped"] == 0
    finally:
        srv.shutdown()


def test_serve_webhook_anonymous_close_flush_posts(receiver):
    srv = event_server(event_webhook=receiver.url)
    clip = event_clip()
    try:
        c = DiPsClient(srv.port)           # anonymous
        c.process_many(clip[:8])           # event open at close
        c.close()                          # flush posts the alert
        receiver.wait(1)
        assert receiver.bodies[0]["event"]["start_frame"] == 4
        assert receiver.bodies[0]["session"] is None
    finally:
        srv.shutdown()


def test_serve_webhook_dead_receiver_does_not_block_sessions():
    """Sessions keep flowing at full speed while the alert endpoint is
    down; failures land in metrics, shutdown stays prompt."""
    import socket
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    srv = event_server(event_webhook=f"http://127.0.0.1:{port}/x")
    srv._webhook.retries = 0
    srv._webhook.timeout_s = 0.3
    clip = event_clip()
    try:
        c = DiPsClient(srv.port, session="cam")
        t0 = time.time()
        for i in range(0, 14, 4):
            c.process_many(clip[i:i + 4])
        assert time.time() - t0 < 10.0     # processing never waited on HTTP
        c.close()
        deadline = time.time() + 5
        while srv.metrics()["webhook_failed"] < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert srv.metrics()["webhook_failed"] >= 1
    finally:
        t0 = time.time()
        srv.shutdown()
        assert time.time() - t0 < 5.0


def test_serve_webhook_requires_events():
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED)
    with pytest.raises(ValueError, match="event_webhook requires events"):
        DiPsServer(props, 16, 24, port=0, event_webhook="http://x/y")


def test_serve_webhook_cli_requires_events_flag(capsys):
    from dips_tpu_torch.serve import main
    rc = main(["--port", "0", "--height", "16", "--width", "24",
               "--event-webhook", "http://127.0.0.1:9/x"])
    assert rc == 2
    assert "--events" in capsys.readouterr().err


def test_serve_webhook_counters_in_prometheus_text():
    from dips_tpu_torch.serve import _prometheus_text
    srv = event_server()
    try:
        text = _prometheus_text(srv.metrics())
        for name in ("webhook_delivered", "webhook_failed",
                     "webhook_dropped"):
            assert f"dips_{name}" in text
    finally:
        srv.shutdown()
