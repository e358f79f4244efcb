"""PyTorch port: the acceptance runner (``python -m
eagle_tpu_torch.validate_acceptance``) against the JAX package's
``scripts/validate_acceptance.py``, both in dry-run on the CPU.

Checks: every gate passes; the report's gate names, and each gate's
detail keys but ``reference`` (the one key the JAX report lacks), equal the
JAX runner's; gate A round-trips as many leaves; gate C passes with the
float64 DLT as its reference when OpenCV cannot be imported, and is
skipped (not failed) with trained keypoints and no OpenCV; a missing
weights directory implies dry-run.
"""

import importlib.util
import json
import os
import sys

import torch

from eagle_tpu_torch import validate_acceptance as va

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _jax_runner():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_acceptance", os.path.join(REPO, "scripts", "validate_acceptance.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dry_run_passes_with_the_jax_reports_layout(monkeypatch, tmp_path):
    port_out, jax_out = tmp_path / "port.json", tmp_path / "jax.json"
    assert va.main(["--dry-run", "--frames", "2", "--device", "cpu", "--out", str(port_out)]) == 0
    monkeypatch.setattr(sys, "argv", ["validate_acceptance.py", "--dry-run", "--frames", "2", "--out", str(jax_out)])
    assert _jax_runner().main() == 0
    got, want = json.loads(port_out.read_text()), json.loads(jax_out.read_text())
    assert got["dry_run"] is True and sorted(got) == sorted(want)
    assert list(got["gates"]) == list(want["gates"])
    for name, gate in got["gates"].items():
        assert gate["status"] == "PASS" and gate["enforced"] is True, (name, gate)
        assert sorted(k for k in gate if k != "reference") == sorted(want["gates"][name]), name
    assert got["gates"]["converter_roundtrip"]["leaves"] == want["gates"]["converter_roundtrip"]["leaves"]
    assert got["gates"]["detector_iou"]["mean_iou"] >= 0.99
    assert got["gates"]["detector_iou"]["boxes_matched"] > 0
    assert got["gates"]["pitch_rmse"]["max_rmse_m"] <= 1e-2
    assert got["gates"]["pitch_rmse"]["reference"] == "cv2"


def test_pitch_gate_without_opencv(monkeypatch, tmp_path):
    """With ``cv2`` unimportable: the dry run passes against the float64
    DLT; trained keypoints are recorded as a skip."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    report = {"gates": {}}
    assert va.gate_c_pitch_rmse(va.Gate(report), str(tmp_path), 2, True, CPU)
    gate = report["gates"]["pitch_rmse"]
    assert gate["status"] == "PASS" and gate["reference"] == "numpy_dlt" and gate["max_rmse_m"] <= 1e-2
    (tmp_path / "hrnet_w48.msgpack").write_bytes(b"")
    assert va.gate_c_pitch_rmse(va.Gate(report), str(tmp_path), 2, False, CPU)
    gate = report["gates"]["pitch_rmse"]
    assert gate["status"] == "SKIP" and gate["enforced"] is False and "OpenCV" in gate["reason"]


def test_missing_weights_dir_implies_dry_run(tmp_path):
    out = tmp_path / "acceptance.json"
    rc = va.main(["--weights-dir", str(tmp_path / "nonexistent"), "--frames", "2", "--device", "cpu",
                  "--out", str(out)])
    assert rc == 0
    assert json.loads(out.read_text())["dry_run"] is True
