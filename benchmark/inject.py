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

With the tracker's appearance network on (the OSNet embedder), the
instance's ``embed`` is wrapped too: the real OSNet runs on the current
detector call's oracle boxes, mapped into the pixels ``embed`` receives
(``x * gain + pad`` on the working canvas, as is on raw frames), and the
detector call returns the oracle rows with an identity embedding a slot
(a seeded unit vector: slot p is player p, then the ball; invalid slots
zero) ``+ 0.0 *`` all of the real rows' columns.  The tracker so sees the
scene's identities behind a full real forward.  The rows with their
identities, and the mapped boxes of each geometry, are device tables made
in set-up (the mapped ones on the warm-up's first call).

For the judge, a seeded reservoir keeps the raw outputs of a few detector
and keypoint-network calls of the window (forward hooks on the two
networks), and each call's frames: for the detector from the order above,
for the keypoint network by an exact integer fingerprint of its input
frames matched against the detector's inputs.  A third keeps a few embed
calls' real embeddings, frames and the boxes the OSNet cropped.  The
fingerprints and the samples' copies are the benchmark's own device work
inside the window: they run under the host range ``bench:inject``, which
the trace gives to no program stage (:class:`benchmark.trace.Stretch`),
and a traced run reports their device time.
"""

from __future__ import annotations

import collections
import random

import numpy as np
import torch
from torch.profiler import record_function

from benchmark.reference.preprocess import canvas_boxes
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
    valid] row of the still camera; ``keep``: how many detector, keypoint
    and embed calls of the window the judge gets."""

    def __init__(self, model, tables: list[np.ndarray], kp_row: np.ndarray, keep: int, seed: int):
        tcfg = model.config.tracker
        self.appearance = bool(tcfg.use_appearance)
        if model._custom_det or model._custom_kp:
            raise ValueError("the injection wraps the built-in models")
        if self.appearance and (tcfg.embedder != "osnet" or model.reid_model is None):
            raise ValueError("the injection carries the embeddings of the OSNet embedder only")
        dev = model.device
        self.shot = [len(t) for t in tables]
        # each table extended by its first PIECE-sized run, so that a batch
        # that runs over the shot's end into its start (a cut back) is a view
        ext = [np.concatenate([t, t[:64]]) for t in tables]
        #: the oracle boxes in original pixels, and their maps by geometry
        self.boxes, self.mapped = None, {}
        if self.appearance:
            self.boxes = [torch.from_numpy(np.ascontiguousarray(t[..., :4])).to(dev) for t in ext]
            ident = identities(ext[0].shape[1], tcfg.embed_dim, seed + 3)
            ext = [np.concatenate([t, ident[None] * t[..., 6:7]], -1, dtype=np.float32) for t in ext]
        self.tables = [torch.from_numpy(t).to(dev) for t in ext]
        self.kp_row = torch.from_numpy(kp_row.astype(np.float32)).to(dev)
        self.pending: collections.deque = collections.deque()
        self.capturing = False
        self.check_finite = False
        self.det_keep, self.kp_keep = Reservoir(keep, seed), Reservoir(keep, seed + 1)
        self.reid_keep = Reservoir(keep, seed + 2)
        #: per detector call of the window: (fingerprints (b,) on the device, [(table, row)])
        self.det_frames: list = []
        self._det_slot = self._kp_slot = None
        #: the detector call in progress: (table, start, b, its frames, its geometry)
        self._call = None
        self._weights: dict = {}
        self._real_det, self._real_kp = model.run_detector, model.run_keypoints
        model.run_detector, model.run_keypoints = self.run_detector, self.run_keypoints
        self._real_embed = None
        if self.appearance:
            self._real_embed = model.embed
            model.embed = self.embed
            self.reid_slots = min(tcfg.reid_slots, ext[0].shape[1])
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
        self._real_det = self._real_kp = self._real_embed = None
        self.tables = self.kp_row = self.boxes = None
        self.mapped = {}

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
        self._call = (table, start, b, frames, geom)
        try:
            real = self._real_det(x, geom, img_hw, timer)
        finally:
            self._det_slot = self._call = None
        oracle = self.tables[table][start : start + b]
        return self._mix(oracle, real[..., : oracle.shape[-1]], "detector")

    def _mapped(self, table: int, geom) -> torch.Tensor:
        """The oracle boxes of shot ``table`` in the pixels of the frames
        the program crops from: ``x * gain + pad`` in float32 on the
        working canvas, as they are on raw frames; one table a geometry."""
        g = {"gain": geom.gain, "pad_x": geom.pad_x, "pad_y": geom.pad_y} if geom.enabled else None
        key = (table, *g.values()) if g else (table,)
        if key not in self.mapped:
            with record_function(OWN):
                self.mapped[key] = canvas_boxes(self.boxes[table], g)
        return self.mapped[key]

    def embed(self, x, boxes):
        """The real ``embed`` on the current detector call's oracle boxes
        (the boxes the program found are left aside)."""
        table, start, b, frames, geom = self._call
        crop = self._mapped(table, geom)[start : start + b]
        out = self._real_embed(x, crop)
        if self.capturing:
            slot = self.reid_keep.slot()
            if slot is not None:
                k = self.reid_slots
                with record_function(OWN):
                    self.reid_keep.kept[slot] = {"frames": frames, "boxes": crop[:, :k].clone(),
                                                 "out": out[:, :k].detach().clone()}
        return out

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

    def samples(self) -> tuple[list, list, list]:
        """(detector samples, keypoint samples, embed samples), each
        {"frames": [(table, row)], "out": the raw network output}, an embed
        sample's "out" (b, K, E) for its first K = ``reid_slots`` slots and
        its "boxes" (b, K, 4) those the OSNet cropped, in the pixels of the
        frames it was given; a keypoint call's frames are found by their
        fingerprints among the detector's inputs."""
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
        return self.det_keep.items(), kp, self.reid_keep.items()


def identities(slots: int, dim: int, seed: int) -> np.ndarray:
    """(slots, dim) float32: a seeded unit vector a detection slot."""
    v = np.random.default_rng(seed).standard_normal((slots, dim))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
