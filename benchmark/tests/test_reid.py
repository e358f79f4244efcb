"""The harness's appearance network on the CPU: the draw of the existing
configurations' weights unchanged, the plain OSNet against the program's
loader and its FLOP count against a hand count, and a run at a small size
of a test-only configuration with OSNet-x0.25 (``tiny.REID_CELLS``):
correct with ``reid_gap`` among its checks, every detector call carrying
the injected identities, and the float8 control over ``reid_gap``'s limit
(the planted fault of the crops is in ``test_faults.py``).  Run from the
repository's root::

    python -m pytest -q benchmark/tests/test_reid.py
"""

from __future__ import annotations

import hashlib
import json
import os

import pytest
import torch

from benchmark import weights
from benchmark.control import control_gaps
from benchmark.frozen.oracles import oracle_detections_at
from benchmark.frozen.synthetic import make_scene
from benchmark.inject import Injection, identities
from benchmark.reference import hrnet, judge, osnet, preprocess, yolov8
from benchmark.reference.ops import FlopCounter
from benchmark.tests import tiny
from benchmark.work import flops

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OSNET_X025 = tiny.REID_CELLS["l960.reid"][1]

#: sha256 of the weights ``weights.draw`` gives each network of the
#: committed configurations at seed 2**40 + 17 on the CPU (keys and float32
#: bytes in order), as the draw gave them before it took an appearance
#: network: the same generator calls in the same order
PINNED = {
    ("yolov8l-960_hrnet-w48", "detector"): "87420793517eb2554cb6c4bf567b548d564f0e2df74f445819f0ab752babcee2",
    ("yolov8l-960_hrnet-w48", "keypoints"): "c9bdf2ba4f97fc86a693c6501238488c701394236c6f81135d5703f422ebca24",
    ("yolov8m-640_hrnet-w48", "detector"): "badc498ee1fcc07a2596bf94d20185a24fc3e3eba1375b5109caccbcd755b24e",
    ("yolov8m-640_hrnet-w48", "keypoints"): "c9bdf2ba4f97fc86a693c6501238488c701394236c6f81135d5703f422ebca24",
}
#: the program's float32 OSNet against the plain one on the same crops,
#: as ``judge``'s gap: both compute in float32, but the program's crops
#: round each bilinear term as a fused multiply-add and its convolutions
#: and BatchNorm fold sum in another order, so the two differ by float32
#: rounding (about 1e-7 a step), which the randomly drawn network grows
#: some 40 times over its depth (bfloat16's 4e-3 a step reads 0.12-0.22);
#: measured 2.6e-05
LOADER_GAP = 1e-4
SEED = 2**31 + 23


@pytest.mark.parametrize(("config", "network"), sorted(PINNED))
def test_the_existing_configurations_draw_the_same_weights(config, network):
    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")))
    layout = yolov8.layout(cfg["detector"]) if network == "detector" else hrnet.layout(cfg["keypoints"])
    h = hashlib.sha256()
    for k, v in weights.draw(layout, 2**40 + 17, "cpu").items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    assert h.hexdigest() == PINNED[(config, network)]


def test_the_programs_loader_agrees_with_the_plain_osnet():
    from eagle_tpu_torch.models.osnet import embed_boxes, osnet_from_torch

    scene = make_scene(num_frames=2, width=640, height=384, num_players=8, fps=25, seed=3)
    frames = torch.from_numpy(scene.frames)
    boxes = torch.stack([torch.from_numpy(oracle_detections_at(scene, t, 16)[0]) for t in range(2)])[:, :10]
    sd = weights.draw(osnet.layout(OSNET_X025), 5, "cpu")
    yolov8.calibrate(osnet.OSNet(sd, OSNET_X025), preprocess.reid_input(frames[:1], boxes[:1, :9], [256, 128]))
    saved = weights.for_saving(sd, dtype=torch.float32)
    program = osnet_from_torch(saved, use_bf16=False).eval()
    with torch.no_grad():
        got = embed_boxes(program, frames, boxes)
        ref = osnet.OSNet(weights.as_loaded(saved, "cpu"), OSNET_X025)(preprocess.reid_input(frames, boxes, [256, 128]))
    assert judge._gap(got, ref.view(2, 10, -1)) < LOADER_GAP


def test_flop_counts_match_a_hand_count_of_one_osnet_block():
    layout = osnet.layout(OSNET_X025)
    ops = FlopCounter()
    net = osnet.OSNet({k: torch.empty(s, device="meta") for k, s in layout.items()}, OSNET_X025, ops)
    net.block(torch.empty(1, 16, 64, 32, device="meta"), "conv2.0")
    hw = 64 * 32
    # conv1 1x1 16->16; ten LightConv3x3 (1x1 16->16, depthwise 3x3 of 16);
    # the gate four times at 1x1 (16->1, 1->16); conv3 and the shortcut 1x1 16->64
    assert ops.flops == 2 * (hw * (16 * 16 + 10 * (16 * 16 + 16 * 9) + 2 * 16 * 64) + 4 * (16 + 16))
    # the paper's 82.3M multiply-adds for x0.25 at 256x128 (Zhou et al., ICCV 2019)
    assert abs(flops.reid(OSNET_X025) / 2 / 82.3e6 - 1) < 0.005


def test_a_run_with_an_appearance_network_is_correct_and_its_control_is_not(monkeypatch):
    rows = []
    real = Injection.run_detector

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        rows.append(out)
        return out

    monkeypatch.setattr(Injection, "run_detector", spy)
    r, driver = tiny.tiny("l960.reid", SEED, 1.0)
    result = driver.run(r)
    ident = torch.from_numpy(identities(rows[0].shape[1], 512, r.sub_seed(5) % (1 << 31) + 3))
    r.free_program()
    checks = r.judge(result)
    assert tiny.correct(checks) and "reid_gap" in checks, checks
    # every detector call: the oracle's 7 columns, then the identities of its valid slots
    assert rows and all(o.shape[-1] == 7 + 512 for o in rows)
    assert all(torch.equal(o[..., 7:], ident * o[..., 6:7]) for o in rows)
    assert control_gaps(r, result)["reid_gap"] > checks["reid_gap"]["limit"]
