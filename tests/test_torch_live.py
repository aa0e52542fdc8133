"""The port's live preview (``live.py``) and the Tk frontend's pure parts
(``gui.py``) against the JAX package's.

The JAX side runs with ``backend="pallas"`` (interpret mode on the CPU),
the port with ``device="cpu"``.  ``rebuild_engine`` (a T, window, method
or mode change on a running engine) is held map for map against the JAX
``rebuild_engine``: COLORIZE maps within 1 LSB, ABSDIFF exact, stats atol
1e-6, the carried checkpoint state equal.  ``run_live`` runs headless with
cv2's window calls stubbed, on a scripted key sequence, and shows the
same frames under the same titles as the JAX loop.
"""

import cv2
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu.gui as jgui
import dips_tpu.live as jlive
import dips_tpu.properties as jp
import dips_tpu_torch.gui as tgui
import dips_tpu_torch.live as tlive
from dips_tpu.models import DiPsEngine as JaxEngine
from dips_tpu_torch import DeviceError, DiPsEngine
from dips_tpu_torch.convert import props_from_jax
from tests.conftest import make_clip

torch.set_num_threads(1)

H, W = 16, 24


def test_controller_matches_jax():
    """Every key through both controllers: the same rebuild answers, the
    same properties, flags and status lines."""
    keys = list("ffffccccoo+-][[]wWWWtTTmmsezaq") + [27, 0x1F600, 300]
    for start in (jp.DiPsProperties(),
                  jp.DiPsProperties(window_size=7, temporal_size=1,
                                    sigmoid_horizontal_scalar=10)):
        j = jlive.LiveController(start, auto_refresh={"threshold": 0.5})
        t = tlive.LiveController(props_from_jax(start),
                                 auto_refresh={"threshold": 0.5})
        for k in keys:
            assert t.handle_key(k) == j.handle_key(k), k
            assert t.props == props_from_jax(j.props), k
            for a in ("snapshot_requested", "quit", "events_enabled",
                      "auto_refresh_enabled", "auto_refresh_cfg"):
                assert getattr(t, a) == getattr(j, a), (k, a)
            assert t.status_line() == j.status_line()


def test_to_bgr_matches_jax():
    rng = np.random.default_rng(0)
    for c in (1, 3):
        m = rng.integers(0, 256, (6, 8, c), np.uint8)
        np.testing.assert_array_equal(tlive._to_bgr(m), jlive._to_bgr(m))
    np.testing.assert_array_equal(tlive._to_bgr(m[..., 0]),
                                  jlive._to_bgr(m[..., 0]))


def _feed(eng, frames):
    return eng.process_frames(list(frames))


def _same(props, got, exp):
    (go, gs), (eo, es) = got, exp
    d = np.abs(go.astype(np.int16) - eo.astype(np.int16))
    raw = props.output in (jp.OutputMode.ABSDIFF, jp.OutputMode.THRESHOLD)
    assert d.max(initial=0) <= (0 if raw else 1)
    np.testing.assert_array_equal(gs[:, 2:], es[:, 2:])
    np.testing.assert_allclose(gs[:, :2], es[:, :2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("start,change", [
    (dict(temporal_size=4), dict(temporal_size=2)),          # T shrinks
    (dict(temporal_size=2), dict(temporal_size=5)),          # T grows
    (dict(window_size=3), dict(window_size=7)),              # window
    (dict(window_size=5, temporal_size=3), dict(window_size=1,
                                                temporal_size=1)),
    (dict(), dict(method=jp.DiPsMethod.PER_FRAME)),          # method
    (dict(), dict(output=jp.OutputMode.GRAYSCALE)),          # same state
    (dict(), dict(output=jp.OutputMode.ABSDIFF)),            # raw: fresh
    (dict(output=jp.OutputMode.ABSDIFF), dict(
        output=jp.OutputMode.THRESHOLD)),                     # raw to raw
], ids=["T4to2", "T2to5", "w3to7", "w5T3tow1T1", "per_frame", "grayscale",
        "to_absdiff", "absdiff_to_threshold"])
def test_rebuild_engine_matches_jax(start, change):
    """Stream, rebuild for new properties, stream on: the port's rebuilt
    engine equals the JAX one batch for batch, state included."""
    frames = make_clip(n=13, h=H, w=W, seed=5)
    props = jp.DiPsProperties(**start)
    new = jp.DiPsProperties(**{**start, **change})
    jeng = JaxEngine(props, H, W, batch=4, backend="pallas")
    teng = DiPsEngine(props_from_jax(props), H, W, batch=4, device="cpu")
    _same(props, _feed(teng, frames[:6]), _feed(jeng, frames[:6]))
    jeng2 = jlive.rebuild_engine(jeng, new, backend="pallas")
    teng2 = tlive.rebuild_engine(teng, props_from_jax(new), device="cpu")
    assert teng2.frame_index == jeng2.frame_index
    js, ts = jeng2.state_dict(), teng2.state_dict()
    if js["tail"] is None:
        assert ts["tail"] is None
    else:
        np.testing.assert_array_equal(ts["tail"], np.asarray(js["tail"]))
    np.testing.assert_array_equal(ts["baseline"][..., :H, :W],
                                  np.asarray(js["baseline"])[..., :H, :W])
    _same(new, _feed(teng2, frames[6:]), _feed(jeng2, frames[6:]))
    np.testing.assert_allclose(teng2.heatmap(), jeng2.heatmap(), atol=1e-4)


def test_rebuild_engine_defaults_to_the_card():
    eng = DiPsEngine(tlive.DiPsProperties(), H, W, batch=1, device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceError):
        tlive.rebuild_engine(eng, tlive.DiPsProperties(temporal_size=2))
    assert tlive.rebuild_engine(eng, eng.props,
                                device="cpu").device.type == "cpu"


class _Reader:
    def __init__(self, frames):
        self.frames = list(frames)
        self.closed = False

    def read(self):
        return self.frames.pop(0) if self.frames else None

    def close(self):
        self.closed = True


def _stub_display(monkeypatch, keys):
    """cv2's window calls stubbed; returns the shown images and titles.
    ``keys`` maps a frame number to the key pressed after it."""
    shown, titles = [], []
    frame = iter(range(10**6))
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setattr(cv2, "namedWindow", lambda *a, **k: None)
    monkeypatch.setattr(cv2, "imshow", lambda _w, img: shown.append(img))
    monkeypatch.setattr(cv2, "setWindowTitle",
                        lambda _w, t: titles.append(t))
    monkeypatch.setattr(cv2, "waitKey",
                        lambda _ms: ord(keys.get(next(frame), "\xff")))
    monkeypatch.setattr(cv2, "destroyAllWindows", lambda: None)
    return shown, titles


def _live_frames():
    """26 still frames (the event detector's idle warm-up after the last
    rebuild), 8 with a moving square, 10 after a lighting flip."""
    still = list(make_clip(n=26, h=H, w=W, seed=3, moving=False))
    moving = list(make_clip(n=8, h=H, w=W, seed=3, moving=True))
    lit = [np.clip(f.astype(np.int16) + 120, 0, 255).astype(np.uint8)
           for f in still[:10]]
    return still + moving + lit


#: the key script, a key after each of the first frames: motion events
#: on, auto-refresh (armed by the run) off, window down and up, T down and
#: up twice, per-frame method, grayscale, back to overall, a snapshot,
#: auto-refresh on again
KEYS = dict(enumerate("eawWtTTmomsa"))


@pytest.mark.parametrize("props", [
    jp.DiPsProperties(),
    jp.DiPsProperties(output=jp.OutputMode.ABSDIFF, window_size=1,
                      temporal_size=1, filter=jp.DiPsFilter.UNFILTERED,
                      roi=(2, 3, 12, 20)),
], ids=["colorize", "absdiff_roi"])
def test_run_live_matches_jax(monkeypatch, capsys, props):
    """The scripted key sequence through both preview loops (batch 1,
    each key rebuilding or toggling): the same number of frames shown,
    each within 1 LSB (ABSDIFF exact), the same titles and printed
    events / re-pins."""
    frames = _live_frames()
    runs = []
    for live, kw, p in ((jlive, dict(backend="pallas"), props),
                        (tlive, dict(device="cpu"), props_from_jax(props))):
        shown, titles = _stub_display(monkeypatch, KEYS)
        reader = _Reader(frames)
        assert live.run_live(p, reader=reader,
                             auto_refresh={"threshold": 0.5, "persist": 2},
                             **kw) == 0
        assert reader.closed
        runs.append((shown, titles, capsys.readouterr().out))
    (ts, tt, tout), (js, jt, jout) = runs[1], runs[0]
    assert len(ts) == len(js) == len(frames)
    assert tt == jt and tout == jout
    raw = props.output == jp.OutputMode.ABSDIFF
    for a, b in zip(ts, js):
        d = np.abs(a.astype(np.int16) - b.astype(np.int16))
        assert d.max(initial=0) <= (0 if raw else 1)
    assert any("events=auto" in t for t in tt)
    assert any("[MOTION]" in t for t in tt)
    assert "auto-refresh: baseline re-pinned" in tout


def test_run_live_headless_fails_gracefully(monkeypatch):
    """No display: exit 1 and the reader released, before any engine (so
    before the card is asked for)."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    r = _Reader(make_clip(n=2, h=H, w=W))
    assert tlive.run_live(tlive.DiPsProperties(), reader=r) == 1
    assert r.closed


def test_run_live_defaults_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _stub_display(monkeypatch, {})
    r = _Reader(make_clip(n=2, h=H, w=W))
    with pytest.raises(DeviceError):
        tlive.run_live(tlive.DiPsProperties(), reader=r)
    assert r.closed


def test_run_live_bad_roi_is_rc1(monkeypatch):
    _stub_display(monkeypatch, {})
    props = tlive.DiPsProperties(roi=(0, 0, H + 5, W))
    assert tlive.run_live(props, reader=_Reader(make_clip(n=2, h=H, w=W)),
                          device="cpu") == 1


def test_cli_live_with_input_uses_that_source(monkeypatch, tmp_path):
    """--live --input FILE previews the file: the CLI opens it and hands
    the reader to run_live; a missing file is rc 1, not the webcam."""
    import dips_tpu_torch.cli as cli
    from dips_tpu_torch.io import moving_square_clip, write_clip
    p = str(tmp_path / "clip.avi")
    write_clip(moving_square_clip(n=2, height=16, width=24), p, fps=10)
    seen = {}

    def fake_run_live(props, device="cuda", reader=None, **kw):
        seen.update(reader=reader, device=device, **kw)
        reader.close()
        return 0

    monkeypatch.setattr(tlive, "run_live", fake_run_live)
    assert cli.main(["--live", "--input", p, "--device", "cpu",
                     "--auto-refresh", "0.5:2"]) == 0
    assert seen["reader"].path == p and seen["device"] == "cpu"
    assert seen["auto_refresh"] == {"threshold": 0.5, "persist": 2}
    assert cli.main(["--live", "--input", str(tmp_path / "no.avi")]) == 1


def test_run_dips_app_is_the_live_loop(monkeypatch):
    import dips_tpu_torch.app as tapp
    seen = {}
    monkeypatch.setattr(tlive, "run_live",
                        lambda props, camera=0, device="cuda": seen.update(
                            props=props, camera=camera, device=device) or 0)
    assert tapp.run_dips_app(camera=2) == 0
    assert seen == dict(props=tlive.DiPsProperties(), camera=2,
                        device="cuda")


@pytest.mark.parametrize("controls", [
    (True, "sigmoid", "all", "overall", 3, 5.0),
    (False, "inv_sig", "g", "per_frame", 6, 2.0),
    (True, "none", "b", "overall", 7, 10.0),
    (True, "none", "r", "per_frame", 1, 0.0),
])
def test_props_from_controls_matches_jax(controls):
    """The widget values give the same properties (the sensitivity slider
    inverted, even windows clamped down)."""
    assert tgui.props_from_controls(*controls) == \
        props_from_jax(jgui.props_from_controls(*controls))
    assert tgui.SENSITIVITY_MAX == jgui.SENSITIVITY_MAX


def test_props_from_controls_rejects_unknown():
    with pytest.raises(KeyError):
        tgui.props_from_controls(True, "nope", "all", "overall", 3, 5.0)


def test_gui_thumbnail_cache_freshness(tmp_path):
    import os
    import time
    video, thumb = tmp_path / "v.avi", tmp_path / "v.avi.thumb.png"
    video.write_bytes(b"x")
    for mod in (tgui, jgui):
        assert not mod.thumbnail_cache_valid(str(video), str(thumb))
    thumb.write_bytes(b"t")
    later = time.time() + 10
    for stamp, want in ((None, True), (later, False)):
        if stamp:
            os.utime(video, (stamp, stamp))
        for mod in (tgui, jgui):
            assert mod.thumbnail_cache_valid(str(video), str(thumb)) is want


def test_run_gui_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceError):
        tgui.run_gui()
