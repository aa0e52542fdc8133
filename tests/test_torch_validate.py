"""The port's acceptance check (``dips_tpu_torch.validate``) on the CPU,
modelled on tests/test_validate_harness.py: its case loop, its JSON
artifact and failure accounting, every case and gate on the plain twins
(``--device cpu``), a gate that must fail on a slab built one row off, and
``--device cuda`` without a card.  The CUDA kernels run the same check on
the card (``chip_smoke.py``'s ``[validate]``)."""

import json

import numpy as np
import pytest
import torch

from dips_tpu import validate as jax_validate
from dips_tpu_torch import validate
from dips_tpu_torch.convert import props_from_jax

torch.set_num_threads(1)

#: the gates that follow the case matrix in a full run, in order
GATES = ["stacked 2-stream kernels", "row-slab dyn-bounds kernel",
         "slab-bands ring kernel (2-section)",
         "raw slab row-bounds (tail+stacked+ring)",
         "band slabs x emit_maps=False", "input-layout hwc_bgr",
         "on-device downscale=2"]


def test_cases_are_the_jax_checks():
    """Same names and properties, so the two artifacts line up."""
    assert [n for n, _, _ in validate.CASES] == \
        [n for n, _, _ in jax_validate.CASES]
    for (_, pp, pe), (_, jp, je) in zip(validate.CASES, jax_validate.CASES):
        assert pp == props_from_jax(jp) and pe == je
    np.testing.assert_array_equal(validate._clip(), jax_validate._clip())


def test_quick_matrix_and_json_artifact(tmp_path):
    path = tmp_path / "v.json"
    assert validate.main(["--device", "cpu", "--quick",
                          "--json", str(path)]) == 0
    doc = json.loads(path.read_text())
    assert doc["tool"] == "dips_tpu_torch.validate"
    assert (doc["device_arg"], doc["device"]) == ("cpu", "cpu")
    assert doc["torch_version"] == torch.__version__ and "card" not in doc
    assert doc["ok"] is True and doc["failed"] == 0 and doc["quick"] is True
    # quick = the first 3 cases, one protocol, no gates
    assert doc["passed"] == len(doc["cases"]) == 3
    # the plain twins ran: no kernel launch is counted
    assert doc["launches"]["batch_step_ring"] == 0
    assert not any(doc["launches"].values())
    assert [c["case"] for c in doc["cases"]] == \
        [n for n, _, _ in validate.CASES[:3]]
    for c in doc["cases"]:
        assert c["ok"] is True and "seconds" in c


def test_full_run_passes_every_case_and_gate():
    results = []
    assert validate.run("cpu", verbose=False, results=results) == 0
    names = [f"{n} [{p}]" for n, _, _ in validate.CASES
             for p in ("ring", "tail")] + GATES
    assert [r["case"] for r in results] == names
    assert all(r["ok"] for r in results), results


def test_soak_passes(tmp_path):
    results = []
    assert validate.soak(64, device="cpu", verbose=False,
                         results=results) == 0
    assert results[0]["case"] == "soak 64f ring-vs-tail + ckpt"
    assert results[0]["ok"] is True
    assert set(results[0]["fps"]) == {"ring", "tail"}
    path = tmp_path / "s.json"
    assert validate.main(["--device", "cpu", "--soak", "32",
                          "--json", str(path)]) == 0
    assert json.loads(path.read_text())["passed"] == 1


@pytest.mark.parametrize("gate,helper,error", [
    ("_run_slab", "_halo_slabs", "slab out != full kernel"),
    ("_run_slab_bands", "_section_bands",
     "band-slab out != full-height ring kernel"),
    # no maps: the stats catch it
    ("_run_band_no_maps", "_section_bands", "Not equal to tolerance")])
def test_a_slab_built_one_row_off_fails(monkeypatch, gate, helper, error):
    """The gates can fail: slabs or bands cut one row off the place the
    neighbour exchange delivers them from."""
    built = getattr(validate, helper)
    monkeypatch.setattr(validate, helper,
                        lambda raw, hs: built(np.roll(raw, 1, axis=-2), hs))
    results = []
    assert getattr(validate, gate)("cpu", False, results) == 1
    (r,) = results
    assert r["ok"] is False and error in r["error"]


def test_record_captures_failure():
    results = []
    validate._record(results, "boom", False, 0.0,
                     error=ValueError("bad lane"))
    (r,) = results
    assert r["ok"] is False
    assert "bad lane" in r["error"]


def test_without_a_card_cuda_exits_1(capsys, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    path = tmp_path / "v.json"
    assert validate.main(["--json", str(path)]) == 1
    assert validate.main(["--device", "cuda", "--quick"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not path.exists()  # no result without a card
