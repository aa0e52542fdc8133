"""The port's doctor (``dips_tpu_torch.doctor``) against the JAX package's.

The ``native``, ``opencv``, ``gstreamer`` and ``report`` sections equal
``dips_tpu.doctor``'s on this host; the ``torch`` section (in place of
JAX's backend probe) reports no card here and names a hang or a failed
CUDA init; the ``kernels`` section (in place of the tuning table) reports
the nvcc and the build directory of the current sources without
building; ``main`` keeps the flags and exit codes.
"""

import json
import subprocess
import sys
import threading
from pathlib import Path

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import pytest
import torch

import dips_tpu.doctor as jdoctor
import dips_tpu_torch.doctor as tdoctor
from dips_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ["torch", "native", "opencv", "gstreamer", "kernels",
            "autotune", "compile_cache", "report"]


@pytest.fixture(scope="module")
def reports():
    return tdoctor.collect(timeout_s=60), jdoctor.collect(timeout_s=60)


def test_sections_in_order(reports):
    got, exp = reports
    assert list(got) == SECTIONS
    assert [s for s in exp if s != "jax"] == \
        [s for s in got if s not in ("torch", "kernels")]


@pytest.mark.parametrize("name", ["native", "opencv", "gstreamer",
                                  "report"])
def test_shared_sections_match_jax(reports, name):
    got, exp = reports
    if name == "report" and got[name]["hint"]:
        # without matplotlib the hint names each package's command
        got[name]["hint"] = got[name]["hint"].replace("dips-torch-",
                                                      "dips-")
    assert got[name] == exp[name]


def test_torch_section_without_a_card(reports):
    got, _ = reports
    t = got["torch"]
    assert t["version"] == torch.__version__
    assert t["cuda"] == torch.version.cuda
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert t["devices"] == 0 and t["device_name"] is None
    assert t["ok"] is False and "--device cpu" in t["hint"]


def test_torch_section_names_a_hang_and_a_failure(monkeypatch):
    release = threading.Event()

    def hang():
        release.wait(10)
        return False

    monkeypatch.setattr(torch.cuda, "is_available", hang)
    t = tdoctor._probe_torch(0.2)
    release.set()
    assert t["ok"] is False and "did not answer within 0.2s" in t["hint"]

    def boom():
        raise RuntimeError("driver exploded")

    monkeypatch.setattr(torch.cuda, "is_available", boom)
    t = tdoctor._probe_torch(5)
    assert t["ok"] is False and "driver exploded" in t["hint"]


def test_torch_section_with_a_card(monkeypatch):
    """With a card: its name, count and nvidia-smi's power line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(tdoctor, "_power_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    t = tdoctor._probe_torch(5)
    assert t["ok"] is True and t["hint"] is None
    assert (t["devices"], t["device_name"], t["power"]) == (
        1, "NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3, 700.00 W")


def test_kernels_section(monkeypatch, tmp_path):
    """The nvcc ``_build`` finds and the current sources' build directory;
    ok with a built library or an nvcc to build one; nothing built."""
    key = _build.build_key(_build.network_header())
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    k = tdoctor.collect(timeout_s=5)["kernels"]
    assert k["dir"] == str(tmp_path / key) and k["nvcc"] is None
    assert (k["built"], k["ok"]) == (False, False) and "no nvcc" in k["hint"]
    nvcc = "/usr/local/cuda/bin/nvcc"
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    k = tdoctor.collect(timeout_s=5)["kernels"]
    assert (k["nvcc"], k["built"], k["ok"]) == (nvcc, False, True)
    assert "first run on the card builds them" in k["hint"]
    (tmp_path / key).mkdir()
    (tmp_path / key / _build.LIB_NAME).write_bytes(b"")
    k = tdoctor.collect(timeout_s=5)["kernels"]
    assert (k["built"], k["ok"], k["hint"]) == (True, True, None)
    assert list(tmp_path.iterdir()) == [tmp_path / key]  # it built nothing


def test_a_crashing_section_is_reported(monkeypatch):
    def boom():
        raise OSError("no such thing")

    monkeypatch.setattr(tdoctor, "_probe_torch", lambda t: boom())
    info = tdoctor.collect(timeout_s=5)
    assert info["torch"]["ok"] is False
    assert "no such thing" in info["torch"]["error"]
    assert list(info) == SECTIONS


def test_main_flags_and_exit_codes(monkeypatch, capsys):
    """--json prints one JSON object; the text report marks each section;
    exit code 1 when a section is not ok, 0 when all are."""
    assert tdoctor.main(["--json", "--timeout", "30"]) == (
        0 if all(d["ok"] for d in tdoctor.collect(30).values()) else 1)
    info = json.loads(capsys.readouterr().out)
    assert list(info) == SECTIONS
    fine = {s: {"ok": True, "hint": None, "x": 1} for s in SECTIONS}
    monkeypatch.setattr(tdoctor, "collect", lambda timeout_s: fine)
    assert tdoctor.main([]) == 0
    out = capsys.readouterr().out
    assert out.splitlines() == [f"[ok] {s}: x=1" for s in SECTIONS]
    bad = dict(fine, kernels={"ok": False, "hint": "fix it"})
    monkeypatch.setattr(tdoctor, "collect", lambda timeout_s: bad)
    assert tdoctor.main([]) == 1
    cap = capsys.readouterr()
    assert "[!!] kernels: " in cap.out and "-> fix it" in cap.out
    assert "attention: kernels" in cap.err


def test_module_entry_point():
    res = subprocess.run([sys.executable, "-m", "dips_tpu_torch.doctor",
                          "--json", "--timeout", "30"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    info = json.loads(res.stdout)
    assert list(info) == SECTIONS
    assert res.returncode == (0 if all(d["ok"] for d in info.values())
                              else 1)
    if not torch.cuda.is_available():
        assert res.returncode == 1 and "torch" in res.stderr
