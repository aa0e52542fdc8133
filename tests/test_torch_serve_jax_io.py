"""The port's daemon and the JAX package's exchange clients and
checkpoints, and fail alike on bad flags (CPU).

* Wire compatibility: the JAX client against the port's daemon and the
  port's client against the JAX daemon; the replies are the serving
  engine's own, bit for bit.
* Checkpoints: a JAX daemon's autosave restored by the port's daemon and
  the reverse, dedicated and coalesced, COLORIZE and ABSDIFF; the
  continued stream equals an uninterrupted engine of the restoring
  package bit for bit.
* The daemon CLI: each bad-flag case gives the JAX ``main``'s exit code and
  message.

Sizes and the JAX side as in ``tests/test_torch_serve_jax.py``.
"""

import threading

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.serve as jserve
import dips_tpu_torch.serve as tserve
from dips_tpu.models import DiPsEngine as JaxEngine
from dips_tpu.properties import DiPsProperties, OutputMode
from dips_tpu_torch.convert import props_from_jax
from tests._torch_serve import DiPsEngine as TorchEngine
from tests._torch_serve import wait_autosaves
from tests.conftest import make_clip
from tests.test_torch_serve_jax import B, H, MODES, W, serve_pair, session

torch.set_num_threads(1)


@pytest.mark.parametrize("direction", ["jax_client_port_daemon",
                                       "port_client_jax_daemon"])
def test_clients_cross_packages(direction):
    """Each package's client drives the other's daemon: the replies are
    the serving engine's own (maps and stats bit for bit)."""
    props = DiPsProperties(output=OutputMode.ABSDIFF, temporal_size=4)
    clip = make_clip(n=7, h=H, w=W, seed=9)
    js, ts = serve_pair(props, max_sessions=2)
    try:
        if direction == "jax_client_port_daemon":
            maps, stats, heat = session(ts.port, clip,
                                        client=jserve.DiPsClient,
                                        session="cam")
            eng = TorchEngine(props_from_jax(props), H, W, batch=B)
        else:
            maps, stats, heat = session(js.port, clip,
                                        client=tserve.DiPsClient,
                                        session="cam")
            eng = JaxEngine(props, H, W, batch=B, backend="pallas")
    finally:
        js.shutdown()
        ts.shutdown()
    o1, s1 = eng.process_frames(list(clip[:4]))
    eng.snapshot()
    o2, s2 = eng.process_frames(list(clip[4:]))
    np.testing.assert_array_equal(maps, np.concatenate([o1, o2]))
    np.testing.assert_array_equal(stats, np.concatenate([s1, s2]))
    np.testing.assert_array_equal(heat, np.asarray(eng.heatmap()))


@pytest.mark.parametrize("props", MODES[::2], ids=["colorize", "absdiff"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("coalesce", [0, 2], ids=["dedicated", "coalesced"])
def test_autosave_crosses_packages(tmp_path, props, direction, coalesce):
    """A daemon of one package autosaves a named session and "crashes";
    the other package's daemon restores it from the same directory, and
    the continued stream equals an uninterrupted engine of the restoring
    package."""
    clip = make_clip(n=8, h=H, w=W, seed=13)
    kw = dict(port=0, batch=B, max_sessions=2, coalesce=coalesce,
              autosave_dir=str(tmp_path), autosave_every=2)
    jax_first = direction == "jax_to_port"

    def start(jax_side):
        srv = (jserve.DiPsServer(props, H, W, backend="pallas", **kw)
               if jax_side else
               tserve.DiPsServer(props_from_jax(props), H, W, device="cpu",
                                 **kw))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv

    first = start(jax_first)
    c = tserve.DiPsClient(first.port, session="cam")
    c.process_many(clip[:4])
    wait_autosaves(first, 1)
    first.shutdown()  # no close: the autosave is all that survives
    second = start(not jax_first)
    try:
        with tserve.DiPsClient(second.port, session="cam") as c2:
            assert c2.hello()["frame_index"] == 4
            maps, stats = c2.process_many(clip[4:])
        assert second.metrics()["autorestores"] == 1
    finally:
        second.shutdown()
    eng = (TorchEngine(props_from_jax(props), H, W, batch=B) if jax_first
           else JaxEngine(props, H, W, batch=B, backend="pallas"))
    eng.process_frames(list(clip[:4]))
    exp_maps, exp_stats = eng.process_frames(list(clip[4:]))
    # the restoring package's own engine: bit for bit
    np.testing.assert_array_equal(maps, exp_maps)
    np.testing.assert_array_equal(stats, exp_stats)


BAD_FLAGS = [
    ["--event-webhook", "http://127.0.0.1:9/x"],
    ["--events", "--event-off", "0.1"],
    ["--auto-refresh", "half"],
    ["--coalesce", "2", "--coalesce-mesh", "oops"],
    ["--coalesce", "2", "--coalesce-mesh", "1x4", "--coalesce-devices", "2"],
    ["--coalesce-mesh", "1x4"],
    ["--coalesce", "2", "--coalesce-mesh", "0x4"],
    ["--roi", "0,0,99,99"],
    ["--roi", "1,2,3"],
]


@pytest.mark.parametrize("flags", BAD_FLAGS,
                         ids=lambda f: "_".join(f).strip("-")[:40])
def test_daemon_bad_flags_match_the_jax_daemon(flags, capsys):
    """Usage errors: the same exit code and message as the JAX daemon's
    ``main``.  The port's daemon is given ``--device cpu`` so that the
    roi cases reach the engine as the JAX ones do."""
    from dips_tpu.serve.daemon import main as jmain
    from dips_tpu_torch.serve.daemon import main as tmain
    argv = ["--port", "0", "--height", "16", "--width", "24"] + flags
    jrc = jmain(argv + ["--backend", "xla"])
    jerr = capsys.readouterr().err
    trc = tmain(argv + ["--device", "cpu"])
    terr = capsys.readouterr().err
    assert trc == jrc == 2
    assert terr == jerr and terr.strip()
