"""The port's run path (``run_dips_on_file``, the CLI) against the JAX
package's, on a small MJPG clip made with numpy from a seed.

Both decode the same file with the same cv2, so they see the same frames.
The diff videos are written losslessly (HFYU) and compared frame by frame:
ABSDIFF exact, emphasis maps within 1 LSB; stats atol 1e-6 with changed
counts and maxima exact.
"""

import cv2
import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import dips_tpu
import dips_tpu.cli
import dips_tpu_torch
import dips_tpu_torch.cli
from dips_tpu_torch.convert import props_from_jax
from tests.conftest import make_clip

torch.set_num_threads(1)

H, W = 16, 200


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "in.avi")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 10, (W, H))
    for f in make_clip(n=11, h=H, w=W, seed=8):
        vw.write(f[..., ::-1])
    vw.release()
    return path


def read_video(path):
    cap = cv2.VideoCapture(path)
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    cap.release()
    return np.stack(frames)


def assert_videos_close(a, b, exact):
    va, vb = read_video(a), read_video(b)
    assert va.shape == vb.shape
    d = np.abs(va.astype(np.int16) - vb.astype(np.int16))
    assert d.max() <= (0 if exact else 1)


def assert_stats_close(got, exp):
    assert got.shape == exp.shape
    np.testing.assert_array_equal(got[:, 2:], exp[:, 2:])
    np.testing.assert_allclose(got[:, :2], exp[:, :2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(output=dips_tpu.OutputMode.ABSDIFF),
    dict(method=dips_tpu.DiPsMethod.PER_FRAME, window_size=5,
         output=dips_tpu.OutputMode.GRAYSCALE),
])
def test_run_dips_on_file_matches_jax(clip_path, tmp_path, kw):
    props = dips_tpu.DiPsProperties(**kw)
    exact = props.output == dips_tpu.OutputMode.ABSDIFF
    jout, tout = str(tmp_path / "j.avi"), str(tmp_path / "t.avi")
    exp = dips_tpu.run_dips_on_file(clip_path, jout, encoding="HFYU",
                                    properties=props, refresh_markers=(6,),
                                    batch=4)
    got = dips_tpu_torch.run_dips_on_file(
        clip_path, tout, encoding="HFYU", properties=props_from_jax(props),
        refresh_markers=(6,), batch=4, device="cpu")
    assert got.shape == (11, 4)
    assert_stats_close(got, exp)
    assert_videos_close(tout, jout, exact)


def test_stats_only_writes_no_video(clip_path):
    props = dips_tpu_torch.DiPsProperties(
        output=dips_tpu_torch.OutputMode.STATS_ONLY)
    stats = dips_tpu_torch.run_dips_on_file(clip_path, None,
                                            properties=props, batch=4,
                                            device="cpu")
    assert stats.shape == (11, 4) and (stats[1:, 3] > 0).all()
    with pytest.raises(dips_tpu_torch.OutputPathError):
        dips_tpu_torch.run_dips_on_file(clip_path, "x.avi",
                                        properties=props, device="cpu")


@pytest.mark.parametrize("args", [
    ["--win_size", "5", "--method", "per_frame", "--batch", "4", "3"],
    ["--output-mode", "threshold", "--batch", "3"],
    ["--colorize", "false", "--filter", "inv_sig", "--chroma", "g",
     "--sig_scalar", "7.5", "--batch", "5"],
])
def test_cli_matches_jax(clip_path, tmp_path, args, capsys):
    jout, tout = str(tmp_path / "j.avi"), str(tmp_path / "t.avi")
    common = ["--input", clip_path, "--encoding", "HFYU"]
    assert dips_tpu.cli.main(common + ["--output", jout] + args) == 0
    assert dips_tpu_torch.cli.main(common + ["--output", tout, "--device",
                                             "cpu"] + args) == 0
    assert "processed 11 frames" in capsys.readouterr().out
    assert_videos_close(tout, jout, exact="threshold" in args)


def test_cli_usage_errors(clip_path, capsys):
    assert dips_tpu_torch.cli.main(["--input", clip_path]) == 2
    assert dips_tpu_torch.cli.main(["--input", clip_path, "--output",
                                    "o.avi", "--encoding", "XYZ"]) == 2
    assert dips_tpu_torch.cli.main(["--input", "/nonexistent.avi",
                                    "--output", "o.avi",
                                    "--device", "cpu"]) == 1


def test_frame_callback_sees_rgb_inputs(clip_path):
    seen = []

    def cb(idx, inp, out, stats):
        seen.append((idx, inp.copy()))
        return None

    job = dips_tpu_torch.DiPsJob(video_path=clip_path, batch=4,
                                 device="cpu", frame_callback=cb)
    rows = list(dips_tpu_torch.stream_dips(job))
    assert [r[0] for r in rows] == list(range(11))
    decoded = read_video(clip_path)[..., ::-1]
    for idx, inp in seen:
        np.testing.assert_array_equal(inp, decoded[idx])
