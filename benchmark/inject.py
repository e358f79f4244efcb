"""The scene's truth behind the program's real forwards, and the judge's
samples of those forwards.

A copy of the idea of ``eagle_tpu_torch/bench.py``'s ``OracleInjection``
(the benchmark's own, so that the yardstick does not move with the
program).  Seeded weights see no pitch and no players, which would drive
the tracker and the Processor into a degenerate path.  So the model
instance's ``run_detector`` (YOLOv8, NMS, the box map) and
``run_keypoints`` (HRNet, the heatmap decode) are wrapped: each calls the
real method and returns ``oracle + 0.0 * real`` on the device, so the real
forward runs in full and the result still waits for it.

Which frames a detector call holds is known from the order the traffic
hands frames out (:meth:`Injection.feed`): the detector sees every frame
once, in that order.  Its oracle rows are views of a device table made in
set-up, so the window makes no host-to-device copy for them.

For the judge, a seeded reservoir keeps the raw outputs of a few detector
and keypoint-network calls of the window (forward hooks on the two
networks), and each call's frames: for the detector from the order above,
for the keypoint network by an exact integer fingerprint of its input
frames matched against the detector's inputs.  The fingerprints and the
samples' copies are the benchmark's own device work inside the window:
they run under the host range ``bench:inject``, which the trace gives to
no program stage (:class:`benchmark.trace.Stretch`), and a traced run
reports their device time.
"""

from __future__ import annotations

import collections
import random

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.trace import OWN

#: elements of a frame the fingerprint reads: every STRIDE-th byte
STRIDE = 7


class Reservoir:
    """A seeded uniform sample of ``k`` of the calls offered."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen = k, random.Random(seed), 0
        self.kept: list = [None] * k

    def slot(self) -> int | None:
        """The slot the next call goes to, or None to leave it out."""
        self.seen += 1
        if self.seen <= self.k:
            return self.seen - 1
        j = self.rng.randrange(self.seen)
        return j if j < self.k else None

    def items(self) -> list:
        return [x for x in self.kept if x is not None]


class Injection:
    """``tables``: one (S, D, 7) float32 array a shot, [x1, y1, x2, y2,
    conf, cls, valid] of every frame; ``kp_row``: the (57, 4) [x, y, score,
    valid] row of the still camera; ``keep``: how many detector and
    keypoint calls of the window the judge gets."""

    def __init__(self, model, tables: list[np.ndarray], kp_row: np.ndarray, keep: int, seed: int):
        if model._custom_det or model._custom_kp or model.config.tracker.use_appearance:
            raise ValueError("the injection wraps the built-in models without appearance embeddings")
        dev = model.device
        self.shot = [len(t) for t in tables]
        # each table extended by its first PIECE-sized run, so that a batch
        # that runs over the shot's end into its start (a cut back) is a view
        self.tables = [torch.from_numpy(np.concatenate([t, t[:64]])).to(dev) for t in tables]
        self.kp_row = torch.from_numpy(kp_row.astype(np.float32)).to(dev)
        self.pending: collections.deque = collections.deque()
        self.capturing = False
        self.check_finite = False
        self.det_keep, self.kp_keep = Reservoir(keep, seed), Reservoir(keep, seed + 1)
        #: per detector call of the window: (fingerprints (b,) on the device, [(table, row)])
        self.det_frames: list = []
        self._det_slot = self._kp_slot = None
        self._weights: dict = {}
        self._real_det, self._real_kp = model.run_detector, model.run_keypoints
        model.run_detector, model.run_keypoints = self.run_detector, self.run_keypoints
        self._hooks = [model.detector_model.register_forward_hook(self._det_hook),
                       model.keypoint_model.register_forward_hook(self._kp_hook)]

    # -- the traffic's side -------------------------------------------

    def feed(self, table: int, start: int, count: int) -> None:
        """``count`` frames of shot ``table`` from ``start`` on were handed
        to the program (thread-safe: deque appends)."""
        self.pending.append([table, start, count])

    def clear(self) -> None:
        self.pending.clear()

    def close(self) -> None:
        """Unhook and drop every reference to the program, so that its
        state can be freed; the judge's samples stay."""
        for h in self._hooks:
            h.remove()
        self._hooks = []
        self._real_det = self._real_kp = None
        self.tables = self.kp_row = None

    # -- the wrappers ---------------------------------------------------

    def _take(self, b: int) -> tuple[int, int]:
        """(table, start) of the next ``b`` frames, which must be one run
        of consecutive shot frames (a cut back to the start included)."""
        table, start, _ = self.pending[0]
        want = start
        left = b
        while left:
            if not self.pending:
                raise RuntimeError("the detector saw more frames than the traffic handed out")
            item = self.pending[0]
            if item[0] != table or item[1] != want % self.shot[table]:
                raise RuntimeError("a detector batch spans frames that do not follow one another")
            n = min(left, item[2])
            item[1] = (item[1] + n) % self.shot[table]
            item[2] -= n
            want += n
            left -= n
            if item[2] == 0:
                self.pending.popleft()
        return table, start

    def _fingerprint(self, x: torch.Tensor) -> torch.Tensor:
        """(b,) int64: a weighted sum of every ``STRIDE``-th byte of each
        frame, exact in integers, so equal frames give equal prints."""
        v = x.reshape(x.shape[0], -1)[:, ::STRIDE]
        key = (v.shape[1], str(v.device))
        if key not in self._weights:
            g = torch.Generator(device=v.device).manual_seed(12345)
            self._weights[key] = torch.randint(1, 1 << 15, (v.shape[1],), generator=g, device=v.device,
                                               dtype=torch.int32)
        return (v.to(torch.int32) * self._weights[key]).sum(1, dtype=torch.int64)

    def _mix(self, oracle: torch.Tensor, real: torch.Tensor, what: str) -> torch.Tensor:
        if self.check_finite and not bool(torch.isfinite(real).all()):
            raise RuntimeError(f"the real {what} rows hold non-finite values: 0.0 * nan would reach the oracle's")
        return oracle + 0.0 * real

    def run_detector(self, x, geom, img_hw, timer=None):
        b = int(x.shape[0])
        table, start = self._take(b)
        frames = [(table, (start + i) % self.shot[table]) for i in range(b)]
        if self.capturing:
            with record_function(OWN):
                self.det_frames.append((self._fingerprint(x), frames))
            self._det_slot = self.det_keep.slot()
            if self._det_slot is not None:
                self.det_keep.kept[self._det_slot] = {"frames": frames}
        try:
            real = self._real_det(x, geom, img_hw, timer)
        finally:
            self._det_slot = None
        return self._mix(self.tables[table][start : start + b], real[..., :7], "detector")

    def run_keypoints(self, x, geom, img_hw):
        b = int(x.shape[0])
        if self.capturing:
            self._kp_slot = self.kp_keep.slot()
            if self._kp_slot is not None:
                with record_function(OWN):
                    self.kp_keep.kept[self._kp_slot] = {"prints": self._fingerprint(x)}
        try:
            real = self._real_kp(x, geom, img_hw)
        finally:
            self._kp_slot = None
        return self._mix(self.kp_row.expand(b, *self.kp_row.shape), real[..., :4], "keypoint")

    def _det_hook(self, module, inputs, output):
        if self._det_slot is not None:
            boxes, scores = output
            with record_function(OWN):
                self.det_keep.kept[self._det_slot]["out"] = (boxes.detach().clone(), scores.detach().clone())

    def _kp_hook(self, module, inputs, output):
        if self._kp_slot is not None:
            with record_function(OWN):
                self.kp_keep.kept[self._kp_slot]["out"] = output.detach().clone()

    # -- after the window ----------------------------------------------

    def samples(self) -> tuple[list, list]:
        """(detector samples, keypoint samples), each {"frames": [(table,
        row)], "out": the raw network output}; a keypoint call's frames are
        found by their fingerprints among the detector's inputs."""
        lookup = {}
        for prints, frames in self.det_frames:
            lookup.update(zip(prints.tolist(), frames))
        kp = []
        for item in self.kp_keep.items():
            prints = item["prints"].tolist()
            missing = [p for p in prints if p not in lookup]
            if missing:
                raise RuntimeError(f"{len(missing)} keypoint frames match no detector input of the window")
            kp.append({"out": item["out"], "frames": [lookup[p] for p in prints]})
        return self.det_keep.items(), kp
