"""One-command acceptance runner (the port's ``scripts/validate_acceptance.py``).

    python -m eagle_tpu_torch.validate_acceptance [--weights-dir DIR] [--torch-dir DIR]
        [--frames 8] [--dry-run] [--size N] [--out report.json] [--reference-results PATH] [--device cpu]

The BASELINE.md gates, on this package:

  A. converter round trip  -- every ``.msgpack`` in the weights directory
                              loads, and a fresh conversion of its torch
                              source is leaf-for-leaf bit-equal to it
  B. detection-box IoU     -- the port's YOLOv8 module, loaded from an
                              ultralytics state dict, against the torch
                              transcription (``tests/torch_graphs.py``) on
                              the same state dict: matched-box IoU >= 0.99
  C. pitch-coordinate RMSE -- image points to pitch metres through the
                              port's RANSAC homography on the device and
                              through a float64 reference on the same
                              correspondences: max RMSE <= 1e-2 m
  D. results.json schema   -- the eval harness emits the reference
                              artifact's metric-key structure

Without ``.msgpack`` weights in the weights directory it runs as
``--dry-run``: seeded random models (a YOLOv8-n), the synthetic scene of
:mod:`eagle_tpu_torch.utils.synthetic`, and the oracle keypoints for gate C,
so every gate is enforced and weight-independent.

Gate C's reference is ``cv2.findHomography(..., cv2.RANSAC, 5.0)`` where
OpenCV imports, as in the JAX runner.  Where it does not (the card's
machine), the dry run's reference is a float64 DLT over all the valid
correspondences (the oracle's are exact, so RANSAC's consensus is all of
them), and a run with trained keypoints records the gate as ``SKIP``.  The
gate's detail names the reference (``"reference": "cv2" | "numpy_dlt"``).

Gate D reads the reference checkout's ``results.json`` for its schema when
``--reference-results`` names one that exists, else the built-in
:data:`FALLBACK_SCHEMA` (the artifact's keys).

The models run on the card unless ``--device cpu`` is given; with no card
and no ``--device cpu`` the runner raises.  Exit code 0 when every enforced
gate passes.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from eagle_tpu_torch import pitch
from eagle_tpu_torch.evaluate import synthetic_truth
from eagle_tpu_torch.pipeline.coordinate_model import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the reference artifact's metric-key structure, used when no reference
# results.json is given (mirrors the reference results.json)
FALLBACK_SCHEMA = {
    "metrics": ["2", "4", "8", "12"],
    "classification": [
        f"{m}_{t}"
        for t in (2, 4, 8, 12)
        for m in ("precision", "recall", "f1", "true_positives", "false_positives", "false_negatives")
    ]
    + ["pdj"],
}


class Gate:
    def __init__(self, report):
        self.report = report

    def record(self, name, ok, detail, enforced=True, skipped=False):
        status = "SKIP" if skipped else ("PASS" if ok else "FAIL")
        self.report["gates"][name] = {
            "status": status,
            "enforced": bool(enforced and not skipped),
            **detail,
        }
        print(f"[{status}] {name}: {json.dumps(detail)}", flush=True)
        return skipped or ok or not enforced


def _leaves(tree, prefix: str = "") -> dict:
    """{path: array} of a parameter tree's non-``None`` leaves, list indices
    as keys (so a tree and its ``.msgpack`` reload, whose lists are maps
    keyed "0", "1", ..., flatten alike)."""
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}{k}."))
    return out


def _bit_equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a
    )


def gate_a_converter_roundtrip(g, weights_dir, torch_dir, dry_run):
    """Every msgpack in weights_dir loads; when its torch source exists,
    a fresh conversion must be leaf-for-leaf bit-identical."""
    from eagle_tpu_torch.models.checkpoint import convert_and_save, load_params, save_params

    pairs = {  # msgpack name -> (kind, torch source name)
        "hrnet_w48.msgpack": ("hrnet", "keypoints_main.pth"),
        "yolov8l_hd.msgpack": ("yolov8", "detector_large_hd.pt"),
        "yolov8l.msgpack": ("yolov8", "detector_large.pt"),
        "yolov8m.msgpack": ("yolov8", "detector_medium.pt"),
        "osnet_x0_25.msgpack": ("osnet", "osnet_x0_25_msmt17.pt"),
    }
    found, roundtripped, mismatches = 0, 0, []
    for name, (kind, src_name) in pairs.items():
        path = os.path.join(weights_dir, name)
        if not os.path.exists(path):
            continue
        found += 1
        params = _leaves(load_params(path))
        if not params:
            mismatches.append(f"{name}: empty tree")
            continue
        src = os.path.join(torch_dir, src_name)
        if os.path.exists(src) and kind in ("hrnet", "yolov8"):
            with tempfile.TemporaryDirectory() as td:
                fresh_path = os.path.join(td, name)
                convert_and_save(src, fresh_path, kind)
                fresh = _leaves(load_params(fresh_path))
            if not _bit_equal(params, fresh):
                mismatches.append(f"{name}: reconversion differs from stored msgpack")
            else:
                roundtripped += 1
    if found == 0 and dry_run:
        # plumbing check: save+load a seeded tree bit-exact
        from eagle_tpu_torch.models.bridge import params_from_module
        from eagle_tpu_torch.models.yolov8 import init_yolov8

        tree = params_from_module(init_yolov8(0, "n", 5))
        params = _leaves(tree)
        with tempfile.TemporaryDirectory() as td:
            back = _leaves(load_params(save_params(tree, os.path.join(td, "t.msgpack"))))
        return g.record(
            "converter_roundtrip", _bit_equal(params, back), {"mode": "dry-run save/load", "leaves": len(params)}
        )
    return g.record(
        "converter_roundtrip",
        not mismatches and found > 0,
        {"msgpacks_found": found, "torch_roundtripped": roundtripped, "mismatches": mismatches},
    )


def _torch_graphs():
    """``tests/torch_graphs.py`` (the YOLOv8 transcription, torch only), the
    gate's reference; a test module, reached through the repository's
    ``tests`` directory."""
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_graphs

    return torch_graphs


def gate_b_detector_iou(g, weights_dir, torch_dir, frames, dry_run, size, device):
    """Confidence-filtered boxes of the port's YOLOv8 (on ``device``) against
    the torch transcription (on the CPU) on the same weights: matched-box
    IoU >= 0.99 and the same count in every frame.

    With real weights the state dict comes from the bundle; in dry-run both
    nets share a randomly initialized state dict -- the gate is equally
    meaningful (it measures forward parity, not accuracy)."""
    from eagle_tpu_torch.eval import box_iou
    from eagle_tpu_torch.models.bridge import yolov8_from_jax
    from eagle_tpu_torch.models.convert import yolov8_from_torch
    from eagle_tpu_torch.utils.synthetic import make_scene

    graphs = _torch_graphs()
    variant = "n" if dry_run else "l"
    src = os.path.join(torch_dir, "detector_large_hd.pt")
    if dry_run or not os.path.exists(src):
        tm = graphs.randomize_(graphs.YoloV8Torch(variant=variant, nc=5), seed=11)
    else:
        sd = torch.load(src, map_location="cpu", weights_only=False)  # a trusted file, as the JAX runner
        if isinstance(sd, dict) and "model" in sd and hasattr(sd["model"], "state_dict"):
            sd = sd["model"].state_dict()
        elif hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        if not any(k.startswith("model.") for k in sd):
            sd = {f"model.{k}": v for k, v in sd.items()}
        tm = graphs.YoloV8Torch(variant=variant, nc=5)
        tm.load_state_dict(sd)
    tm.eval()
    net = yolov8_from_jax(yolov8_from_torch(tm.state_dict())).to(device).eval()

    scene = make_scene(num_frames=frames, width=2 * size, height=size, num_players=8, seed=5)
    x = torch.from_numpy(scene.frames[:frames].astype(np.float32) / 255.0).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        tb, ts = (a.numpy() for a in tm(x))
        pb, ps = (a.float().cpu().numpy() for a in net(x.to(device)))

    # confidence-filter per frame on each side's own scores, then match
    ious, n_mismatch = [], 0
    for i in range(frames):
        tc = ts[i].max(axis=-1) > 0.25
        pc = ps[i].max(axis=-1) > 0.25
        if tc.sum() != pc.sum():
            n_mismatch += 1
        if tc.sum() == 0 or pc.sum() == 0:
            continue
        ious.extend(box_iou(pb[i][pc], tb[i][tc]).max(axis=-1).tolist())
    mean_iou = float(np.mean(ious)) if ious else float("nan")
    ok = bool(ious) and mean_iou >= 0.99 and n_mismatch == 0
    return g.record(
        "detector_iou",
        ok,
        {
            "variant": variant,
            "frames": frames,
            "boxes_matched": len(ious),
            "mean_iou": None if np.isnan(mean_iou) else round(mean_iou, 5),
            "count_mismatch_frames": n_mismatch,
            "threshold": 0.99,
        },
    )


def _dlt_float64(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The normalised DLT homography src -> dst over all the points, in
    float64 (SVD of the Hartley-normalised system), with H[2, 2] = 1."""

    def norm(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / np.mean(np.linalg.norm(p - c, axis=1))
        return np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])

    ts, td = norm(src), norm(dst)
    a = np.concatenate([src, np.ones((len(src), 1))], 1) @ ts.T
    b = np.concatenate([dst, np.ones((len(dst), 1))], 1) @ td.T
    rows = []
    for (x, y, _), (u, v, _) in zip(a, b):
        rows.append([-x, -y, -1, 0, 0, 0, u * x, u * y, u])
        rows.append([0, 0, 0, -x, -y, -1, v * x, v * y, v])
    h = np.linalg.svd(np.asarray(rows))[2][-1].reshape(3, 3)
    H = np.linalg.inv(td) @ h @ ts
    return H / H[2, 2]


def gate_c_pitch_rmse(g, weights_dir, frames, dry_run, device):
    """End-to-end pitch-coordinate RMSE <= 1e-2: project image points to
    world coordinates through (1) the port's RANSAC homography on the
    device and (2) a float64 reference fit (``cv2.findHomography`` where
    OpenCV imports, else a float64 DLT in the dry run), on the same keypoint
    correspondences.

    With trained weights the correspondences come from the real HRNet;
    in dry-run they are the synthetic scene's oracle keypoints -- the
    gate is weight-independent (it measures the homography+projection
    parity, which is exactly what BASELINE.md's RMSE row pins)."""
    from eagle_tpu_torch.config import HomographyConfig
    from eagle_tpu_torch.ops import prng
    from eagle_tpu_torch.ops.homography import perspective_transform, ransac_homography, sample_minimal_sets
    from eagle_tpu_torch.utils.synthetic import make_scene, project

    try:
        import cv2
    except ImportError:
        cv2 = None
    reference = "numpy_dlt" if cv2 is None else "cv2"
    kp_path = os.path.join(weights_dir, "hrnet_w48.msgpack")
    use_model = not dry_run and os.path.exists(kp_path)
    if use_model and cv2 is None:
        return g.record(
            "pitch_rmse", False,
            {"reason": "OpenCV unavailable: trained keypoints need cv2.findHomography as the reference",
             "reference": reference},
            skipped=True,
        )

    scene = make_scene(num_frames=frames, width=1280, height=720, num_players=6, seed=7)
    if use_model:
        from eagle_tpu_torch.models.bridge import hrnet_from_jax
        from eagle_tpu_torch.models.checkpoint import load_params
        from eagle_tpu_torch.ops.heatmap import decode_heatmaps
        from eagle_tpu_torch.ops.preprocess import preprocess_keypoint

        model = hrnet_from_jax(load_params(kp_path)).to(device).eval()
        with torch.no_grad():
            xb = preprocess_keypoint(torch.from_numpy(scene.frames[:frames]).to(device))
            kp, valid = decode_heatmaps(model(xb.permute(0, 3, 1, 2).contiguous()), 0.5, (720, 1280))
        kp_xy = kp[..., :2].cpu().numpy()
        kp_ok = valid.cpu().numpy()
    else:
        kp_xy, kp_ok = synthetic_truth(scene, (720, 1280))[:2]
        kp_xy = kp_xy.astype(np.float32)

    world = pitch.WORLD_XY.astype(np.float32)
    cfg = HomographyConfig()
    rmses, failures = [], 0
    for i in range(frames):
        ok = kp_ok[i] & pitch.ON_PLANE_MASK
        if ok.sum() < 4:
            failures += 1
            continue
        valid = torch.from_numpy(ok).to(device)
        keys = (prng.random_bits(prng.key(i), (cfg.ransac_iters, 57)) >> 9).astype(np.int32)
        sets = sample_minimal_sets(torch.from_numpy(keys).to(device), valid)
        H_dev, _, found = ransac_homography(
            torch.from_numpy(kp_xy[i]).to(device), torch.from_numpy(world).to(device), valid, sets,
            threshold=cfg.reproj_threshold, refine_steps=cfg.refine_steps, lmeds_fallback=cfg.lmeds_fallback,
        )
        if not bool(found):
            failures += 1
            continue
        src, dst = kp_xy[i][ok].astype(np.float64), world[ok].astype(np.float64)
        if cv2 is None:
            H_ref = _dlt_float64(src, dst)
        else:
            H_ref, _ = cv2.findHomography(src, dst, cv2.RANSAC, 5.0)
        if H_ref is None:
            failures += 1
            continue
        # probe points: the frame's own keypoint pixels (in-view grid)
        p_dev = perspective_transform(H_dev, torch.from_numpy(src.astype(np.float32)).to(device)).cpu().numpy()
        p_ref = project(H_ref, src)
        rmses.append(float(np.sqrt(np.mean(np.sum((p_dev - p_ref) ** 2, axis=-1)))))
    rmse = float(np.max(rmses)) if rmses else float("nan")
    ok = bool(rmses) and rmse <= 1e-2 and failures == 0
    return g.record(
        "pitch_rmse",
        ok,
        {
            "keypoint_source": "hrnet_w48.msgpack" if use_model else "synthetic oracle",
            "frames": frames,
            "failures": failures,
            "max_rmse_m": None if np.isnan(rmse) else round(rmse, 6),
            "threshold": 0.01,
            "reference": reference,
        },
    )


def gate_d_results_schema(g, frames, out_dir, reference_results=None):
    """The eval harness must emit the reference artifact's metric-key
    structure (results.json: per-model metrics/time/classification)."""
    from eagle_tpu_torch.eval import point_metrics
    from eagle_tpu_torch.utils.synthetic import make_scene

    scene = make_scene(num_frames=frames, width=640, height=360, num_players=6, seed=9)
    # the schema check drives the harness with oracle predictions (model
    # choice is irrelevant to the schema; eagle_tpu_torch.evaluate runs
    # the real models)
    kp, valid = synthetic_truth(scene, (360, 640))[:2]
    results = {
        "YOLO": {**point_metrics(kp, valid, kp, valid), "time": 0.0},
        "HRNet": {**point_metrics(kp, valid, kp, valid), "time": 0.0},
    }
    if reference_results is not None and os.path.exists(reference_results):
        with open(reference_results) as f:
            ref = json.load(f)
        schema = {
            "metrics": sorted(ref["YOLO"]["metrics"].keys()),
            "classification": sorted(ref["YOLO"]["classification"].keys()),
        }
        source = "reference artifact"
    else:
        schema = {
            "metrics": sorted(FALLBACK_SCHEMA["metrics"]),
            "classification": sorted(FALLBACK_SCHEMA["classification"]),
        }
        source = "built-in fallback"
    problems = []
    for model_name, section in results.items():
        if sorted(section["metrics"].keys()) != schema["metrics"]:
            problems.append(f"{model_name}.metrics keys differ")
        if sorted(section["classification"].keys()) != schema["classification"]:
            missing = set(schema["classification"]) - set(section["classification"])
            extra = set(section["classification"]) - set(schema["classification"])
            problems.append(f"{model_name}.classification: missing={sorted(missing)} extra={sorted(extra)}")
        if "time" not in section:
            problems.append(f"{model_name}.time missing")
    out_path = os.path.join(out_dir, "results.json")
    with open(out_path, "w") as f:
        json.dump(results, f)
    return g.record(
        "results_schema",
        not problems,
        {"schema_source": source, "problems": problems, "written": out_path},
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--weights-dir", default=os.path.join(ROOT, "weights"))
    p.add_argument("--torch-dir", default=os.path.join(ROOT, "weights_torch"))
    p.add_argument("--frames", type=int, default=8)
    p.add_argument(
        "--dry-run",
        action="store_true",
        help="random weights, small variants; plumbing + weight-independent gates only",
    )
    p.add_argument("--size", type=int, default=None, help="detector input height (gate B)")
    p.add_argument("--out", default=None, help="report JSON path (default: <weights-dir>/acceptance.json)")
    p.add_argument("--reference-results", default=None,
                   help="the reference checkout's eagle/models/weights/results.json (gate D's schema)")
    p.add_argument("--device", default=None, help='"cpu" for the plain CPU path; default the card')
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    have_weights = os.path.isdir(args.weights_dir) and any(
        f.endswith(".msgpack") for f in os.listdir(args.weights_dir)
    )
    dry_run = args.dry_run or not have_weights
    if dry_run and not args.dry_run:
        print(f"no .msgpack weights under {args.weights_dir} -- running --dry-run", flush=True)
    size = args.size or (128 if dry_run else 544)

    out_dir = args.weights_dir if have_weights else tempfile.mkdtemp(prefix="acceptance_")
    report = {"dry_run": dry_run, "weights_dir": args.weights_dir, "gates": {}}
    g = Gate(report)

    ok = True
    ok &= gate_a_converter_roundtrip(g, args.weights_dir, args.torch_dir, dry_run)
    ok &= gate_b_detector_iou(g, args.weights_dir, args.torch_dir, args.frames, dry_run, size, device)
    ok &= gate_c_pitch_rmse(g, args.weights_dir, args.frames, dry_run, device)
    ok &= gate_d_results_schema(g, args.frames, out_dir, args.reference_results)

    out = args.out or os.path.join(out_dir, "acceptance.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report: {out}", flush=True)
    print("ACCEPTANCE " + ("PASSED" if ok else "FAILED"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
