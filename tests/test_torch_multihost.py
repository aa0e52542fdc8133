"""The port's multi-process engine (``dips_tpu_torch/parallel/multihost.py``)
on the CPU.

* A real 2-process gloo cluster of the port (``tests/_torch_mh_worker.py``,
  4 CPU cells per rank: an 8-cell global mesh) over ``tests/_mh_worker.py``'s
  rounds (16 x 24, 8 streams, B = 2; in round 1 rank 0 feeds nothing, the
  lockstep round) in both protocols and the ABSDIFF fleet, with and without
  a per-process checkpoint resume after round 0.  Each rank equals the
  port's single-process fleet bit for bit, and the JAX package's
  single-process 8-device fleet (``tests/test_multihost._expected``,
  Pallas interpret mode for the ring protocol) within the repo's
  tolerances: raw maps exact, emphasis maps within 1 LSB, stats within
  1e-6 (maxima and counts exact), global means within 1e-6.  Every
  subprocess has a timeout, so a deadlock fails instead of hanging.
* Checkpoints between the packages' single-process multi-host engines.
* ``init_multihost`` without a cluster, and through torchrun's
  environment; the engine's refusals.
"""

import os
import socket
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from dips_tpu.parallel import MultiHostStreamEngine as JaxMultiHost
from dips_tpu.properties import DiPsFilter as JaxFilter
from dips_tpu.properties import DiPsProperties as JaxProps
from dips_tpu.properties import OutputMode as JaxMode
from dips_tpu_torch import DiPsProperties, MultiStreamEngine
from dips_tpu_torch.convert import props_from_jax
from dips_tpu_torch.parallel import (MultiHostStreamEngine, grid_mesh,
                                     stream_mesh)
from tests._mh_worker import (BATCH, FRAMES_PER_RANK, H, ROUNDS, S_GLOBAL,
                              W, make_clip)
from tests.test_multihost import _expected as jax_expected
from tests.test_multihost import _rank_of

torch.set_num_threads(1)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_torch_mh_worker.py")
#: a worker's whole run takes a few seconds; a deadlocked one never ends
_TIMEOUT = 120
CELLS = 4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _props(raw: bool) -> JaxProps:
    if raw:
        return JaxProps(output=JaxMode.ABSDIFF, temporal_size=2)
    return JaxProps(window_size=3, temporal_size=2,
                    filter=JaxFilter.UNFILTERED)


def _clips():
    return [make_clip(n=FRAMES_PER_RANK[_rank_of(si)], h=H, w=W,
                      seed=100 + si) for si in range(S_GLOBAL)]


def _port_expected(ring: bool, raw: bool):
    """The port's single-process fleet (no mesh) on the same feeds as
    ``tests/test_multihost._expected``."""
    eng = MultiStreamEngine(props_from_jax(_props(raw)), H, W, S_GLOBAL,
                            batch=BATCH, device="cpu", ring_carry=ring,
                            input_layout="planar")
    clips, cursors = _clips(), [0] * S_GLOBAL
    outs, stats_all, gmeans = [], [], []
    for plan in ROUNDS:
        feed = []
        for si in range(S_GLOBAL):
            k = plan[_rank_of(si)]
            feed.append(list(clips[si][cursors[si]:cursors[si] + k]))
            cursors[si] += k
        out, stats, gmean = eng.process_batch(feed)
        outs.append(out)
        stats_all.append(stats)
        gmeans.append(gmean)
    return outs, stats_all, np.asarray(gmeans), eng.heatmaps()


_EXPECTED = {}


def _expected(ring: bool, raw: bool):
    """(the port's single-process run, the JAX package's), once per
    protocol and mode."""
    if (ring, raw) not in _EXPECTED:
        _EXPECTED[ring, raw] = (_port_expected(ring, raw),
                                jax_expected(ring=ring, raw=raw))
    return _EXPECTED[ring, raw]


def _run_cluster(tmp_path, extra=()):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=_REPO)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, str(r), "2", str(port), str(tmp_path),
         *extra], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for r, p in enumerate(procs):
            out, _ = p.communicate(timeout=_TIMEOUT)
            logs.append(out.decode(errors="replace"))
            assert p.returncode == 0, f"worker {r} failed:\n{logs[r]}"
            assert f"WORKER-{r}-OK" in logs[r]
    finally:
        for p in procs:  # a deadlocked peer must not outlive the test
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.mark.parametrize("extra", [(), ("--checkpoint",), ("--ring",),
                                   ("--ring", "--checkpoint"),
                                   ("--ring", "--raw")],
                         ids=["tail", "tail-checkpoint", "ring",
                              "ring-checkpoint", "raw-ring"])
def test_two_process_cluster_matches_single_process(tmp_path, extra):
    ring, raw = "--ring" in extra, "--raw" in extra
    port, jax_run = _expected(ring, raw)
    _run_cluster(tmp_path, extra)
    seen = np.zeros(S_GLOBAL, bool)
    for r in range(2):
        z = np.load(tmp_path / f"rank{r}.npz")
        ids = z["local_stream_ids"]
        assert list(ids) == list(range(r * CELLS, (r + 1) * CELLS))
        for rnd, plan in enumerate(ROUNDS):
            n_rnd = plan[r]
            out, stats = z[f"out{rnd}"], z[f"stats{rnd}"]
            assert out.shape[1] == n_rnd  # incl. rank 0's empty round
            # the port's single-process fleet: bit for bit
            np.testing.assert_array_equal(out, port[0][rnd][ids, :n_rnd])
            np.testing.assert_array_equal(stats, port[1][rnd][ids, :n_rnd])
            # the JAX package's 8-device fleet: the repo's tolerances
            eo = jax_run[0][rnd][ids, :n_rnd]
            d = np.abs(out.astype(np.int16) - eo.astype(np.int16))
            assert d.max(initial=0) <= (0 if raw else 1)
            es = jax_run[1][rnd][ids, :n_rnd]
            np.testing.assert_array_equal(stats[..., 2:], es[..., 2:])
            np.testing.assert_allclose(stats[..., :2], es[..., :2], rtol=0,
                                       atol=1e-6)
        np.testing.assert_array_equal(z["heatmaps"], port[3][ids])
        seen[ids] = True
        assert (z["frame_cursors"] == FRAMES_PER_RANK[r]).all()
        # the global mean rides the cross-process all-reduce: both ranks
        # agree with the single-process value every round, including the
        # round in which rank 0 runs all-invalid
        np.testing.assert_allclose(z["gmeans"], port[2], rtol=0, atol=1e-6)
        np.testing.assert_allclose(z["gmeans"], jax_run[2], rtol=0,
                                   atol=1e-6)
    assert seen.all()


def _feed(clips, lo, hi):
    return [list(c[lo:hi]) for c in clips]


@pytest.mark.parametrize("ring,raw", [(False, False), (True, False),
                                      (True, True)],
                         ids=["tail", "ring", "raw-ring"])
def test_checkpoints_cross_the_packages(tmp_path, ring, raw):
    """A per-process checkpoint of the JAX package's single-process
    multi-host engine (8 devices) loads into the port's (8 CPU cells), and
    the reverse: both then run the next round alike."""
    jp = _props(raw)
    clips = [make_clip(n=4, h=H, w=W, seed=200 + si)
             for si in range(S_GLOBAL)]

    def jax_eng():
        return JaxMultiHost(jp, H, W, S_GLOBAL, batch=BATCH,
                            backend="pallas" if ring else "xla",
                            ring_carry=ring)

    def port_eng():
        return MultiHostStreamEngine(props_from_jax(jp), H, W, S_GLOBAL,
                                     batch=BATCH,
                                     mesh=stream_mesh(devices=["cpu"] * 8),
                                     device="cpu", ring_carry=ring)

    for src, dst in ((jax_eng, port_eng), (port_eng, jax_eng)):
        a = src()
        a.process_batch(_feed(clips, 0, 2))
        path = str(tmp_path / f"{src.__name__}.npz")
        a.save(path)
        b = dst()
        b.load(path)
        assert b.frame_cursors == [2] * S_GLOBAL
        got = b.process_batch(_feed(clips, 2, 4))
        exp = a.process_batch(_feed(clips, 2, 4))
        d = np.abs(got[0].astype(np.int16) - exp[0].astype(np.int16))
        assert d.max(initial=0) <= (0 if raw else 1)
        np.testing.assert_array_equal(got[1][..., 2:], exp[1][..., 2:])
        np.testing.assert_allclose(got[1][..., :2], exp[1][..., :2],
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[2], exp[2], rtol=0, atol=1e-6)


def _python(code, env_extra=None):
    env = dict(os.environ, PYTHONPATH=_REPO)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=_TIMEOUT)


def test_init_multihost_single_process_and_idempotency():
    """No cluster configured: the single-process topology, no process
    group; a second call returns the same topology."""
    res = _python(
        "import torch.distributed as dist\n"
        "from dips_tpu_torch.parallel import init_multihost\n"
        "a = init_multihost()\n"
        "b = init_multihost()\n"
        "assert a == b and a.process_count == 1, (a, b)\n"
        "assert a.is_coordinator and a.global_device_count == "
        "a.local_device_count\n"
        "assert not dist.is_initialized()\n"
        "print('SINGLE-OK')\n")
    assert res.returncode == 0, res.stdout + res.stderr
    assert "SINGLE-OK" in res.stdout


def test_init_multihost_joins_the_torchrun_environment():
    """torchrun's environment is joined over env://; an environment that
    names a cluster but cannot be joined raises instead of running
    alone."""
    res = _python(
        "import os\n"
        "import torch.distributed as dist\n"
        "from dips_tpu_torch.parallel import init_multihost\n"
        "try:\n"
        "    init_multihost()\n"
        "except ValueError as e:\n"
        "    print('REFUSED', e)\n"
        "os.environ.update(WORLD_SIZE='1', MASTER_ADDR='127.0.0.1',\n"
        f"                  MASTER_PORT='{_free_port()}')\n"
        "info = init_multihost()\n"
        "assert dist.is_initialized() and info.process_count == 1, info\n"
        "dist.destroy_process_group()\n"
        "print('JOINED-OK')\n", {"RANK": "0"})
    assert res.returncode == 0, res.stdout + res.stderr
    assert "REFUSED" in res.stdout and "JOINED-OK" in res.stdout


def _engine(**kw):
    args = dict(n_streams=8, batch=2, mesh=stream_mesh(devices=["cpu"] * 4),
                device="cpu")
    args.update(kw)
    return MultiHostStreamEngine(DiPsProperties(), H, W, **args)


def test_engine_refuses_what_the_jax_engine_refuses(tmp_path):
    with pytest.raises(ValueError, match="1-D stream mesh"):
        _engine(mesh=grid_mesh(2, 2, devices=["cpu"] * 4))
    with pytest.raises(ValueError, match="multiple of the global cell"):
        _engine(n_streams=6)
    for kw in (dict(input_layout="hwc"), dict(packed_wire=True)):
        with pytest.raises(TypeError):  # not parameters, as in JAX
            _engine(**kw)
    eng = _engine()
    assert eng.local_stream_ids == list(range(8)) and eng.n_local_streams == 8
    for call in (lambda: eng.reset_stream(0),
                 lambda: eng.stream_state_dict(0),
                 lambda: eng.load_stream_state(0, {}),
                 lambda: eng.save_stream(0, str(tmp_path / "s.npz")),
                 lambda: eng.load_stream(0, str(tmp_path / "s.npz"))):
        with pytest.raises(NotImplementedError):
            call()
    with pytest.raises(ValueError, match="owns"):
        state = eng.state_dict()
        state["local_stream_ids"] = list(range(1, 9))
        eng.load_state_dict(state)


def test_lockstep_flag_keeps_the_all_empty_round():
    """The single-process fleet returns at once from an all-empty round;
    the multi-process engine runs it (masked invalid), so that its peers'
    all-reduce is met, and its state does not move."""
    assert not MultiStreamEngine._lockstep_collectives
    assert MultiHostStreamEngine._lockstep_collectives
    clips = [make_clip(n=2, h=H, w=W, seed=si) for si in range(8)]
    eng = _engine()
    eng.process_batch(_feed(clips, 0, 2))
    before = eng.state_dict()
    out, stats, gmean = eng.process_batch([[]] * 8)
    assert out.shape == (8, 0, H, W, 3) and stats.shape == (8, 0, 4)
    assert gmean == 0.0
    after = eng.state_dict()
    np.testing.assert_array_equal(after["baseline"], before["baseline"])
    np.testing.assert_array_equal(after["heatmap"], before["heatmap"])
    assert after["frame_cursors"] == before["frame_cursors"]
