"""Shared pieces of the port's serving tests (``tests/test_torch_serve*.py``):
the port's server and engine on the CPU, and the small servers and clips of
``tests/test_serve.py``.

The port's entry points default to the card, so ``DiPsServer`` and
``DiPsEngine`` here are the port's classes with ``device="cpu"``; the test
bodies are otherwise those of the JAX package's serving tests."""

import functools
import threading

import numpy as np

from dips_tpu_torch import serve
from dips_tpu_torch.models import DiPsEngine as _DiPsEngine
from dips_tpu_torch.properties import DiPsFilter, DiPsProperties
from tests.conftest import make_clip

DiPsServer = functools.partial(serve.DiPsServer, device="cpu")
DiPsEngine = functools.partial(_DiPsEngine, device="cpu")


def coalesced_server(n_slots, h=16, w=24, **kw):
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, h, w, port=0, batch=2, coalesce=n_slots, **kw)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, props


def flexible_server(**kw):
    props = DiPsProperties(window_size=3, temporal_size=2,
                           filter=DiPsFilter.UNFILTERED)
    srv = DiPsServer(props, port=0, batch=2, max_sessions=2, **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, props


def absdiff_props():
    from dips_tpu_torch.properties import OutputMode
    return DiPsProperties(window_size=1, temporal_size=2,
                          filter=DiPsFilter.UNFILTERED,
                          output=OutputMode.ABSDIFF)


def wait_autosaves(srv, n, timeout=10.0):
    """Autosaves land AFTER the reply (checkpoint IO must not sit in the
    request latency), so a test 'crash' needs to wait for them."""
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if srv.metrics()["autosaves"] >= n:
            return
        time.sleep(0.02)
    raise AssertionError(
        f"expected {n} autosaves, got {srv.metrics()['autosaves']}")


def event_clip(h=16, w=24):
    """Frames: 4 static, 6 moving, 4 static (uncompressed arrays: the
    changed_frac signal is exact)."""
    static = make_clip(n=4, h=h, w=w, seed=3, moving=False)
    moving = make_clip(n=6, h=h, w=w, seed=3, moving=True)
    return np.concatenate([static, moving, static])


def event_server(**kw):
    from dips_tpu_torch.properties import OutputMode
    props = DiPsProperties(window_size=1, temporal_size=1,
                           filter=DiPsFilter.UNFILTERED,
                           output=OutputMode.ABSDIFF)
    srv = DiPsServer(props, 16, 24, port=0, batch=4, max_sessions=2,
                     events=dict(on_threshold=0.02, metric="changed_frac",
                                 min_frames=2), **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def blink_frames(n, h, w, fps, hz, y=slice(2, 6), x=slice(3, 9), seed=0):
    import math
    r = np.random.default_rng(seed)
    base = r.integers(90, 110, (h, w, 3)).astype(np.float32)
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = base.copy()
        f[y, x] += 80.0 * math.cos(2 * math.pi * hz * i / fps)
        out[i] = np.clip(np.rint(f), 0, 255).astype(np.uint8)
    return out

