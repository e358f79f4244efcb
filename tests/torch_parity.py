"""Shared helpers for the PyTorch port's parity tests (tests/test_torch_*.py):
seeded parameter pytrees for the JAX models with signal-preserving
weights, small numpy <-> torch conversions, leaf-for-leaf pytree
comparison, and writers of checkpoints in the reference's and
ultralytics' state-dict layouts from the port's modules.

The checkpoint writers use torch and numpy only (``chip_smoke.py`` calls
them on the card's machine, which has no JAX)."""

from __future__ import annotations

import numpy as np
import torch


def spread_params(tree, rng: np.random.Generator, gain: float = 0.5, bn: bool = True):
    """Redraw every conv+BN bundle of a JAX parameter pytree with
    ``normal(0, gain / sqrt(fan_in))`` kernels and random BN statistics, so
    activations neither vanish (the reference init, std 0.001, makes every
    heatmap flat) nor explode through the residual sums.  Output convs
    (``w`` + ``b``) get the same kernels and small random biases.  The
    tree may hold ``jax.ShapeDtypeStruct`` leaves (``jax.eval_shape`` of an
    init): only shapes are read."""
    if isinstance(tree, dict):
        if "w" in tree and "bn" in tree:
            w_shape = tuple(tree["w"].shape)
            fan = w_shape[0] * w_shape[1] * w_shape[2]
            c = w_shape[-1]
            out = dict(tree)
            out["w"] = rng.normal(0.0, gain / fan**0.5, w_shape).astype(np.float32)
            if bn:
                out["bn"] = {
                    "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                    "bias": rng.normal(0.0, 0.05, c).astype(np.float32),
                    "mean": rng.normal(0.0, 0.05, c).astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, c).astype(np.float32),
                }
            return out
        if "w" in tree and "b" in tree:  # output conv with bias
            w_shape = tuple(tree["w"].shape)
            fan = w_shape[0] * w_shape[1] * w_shape[2]
            return {
                "w": rng.normal(0.0, gain / fan**0.5, w_shape).astype(np.float32),
                "b": rng.normal(0.0, 0.1, tuple(tree["b"].shape)).astype(np.float32),
            }
        return {k: spread_params(v, rng, gain, bn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spread_params(v, rng, gain, bn) for v in tree]
    return tree


def t(a) -> torch.Tensor:
    """numpy (or JAX) array -> CPU tensor (copied)."""
    return torch.from_numpy(np.array(a))


def n(x) -> np.ndarray:
    """tensor or JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def gumbel_top4(draw: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The top 4 points of a float Gumbel draw (iters, N) over the (N,)
    valid mask, invalid points scoring -inf and equal scores ordered by
    lower index (as ``jax.lax.top_k``): the minimal sets the draw picks."""
    scores = np.where(valid[None, :], draw, -np.inf)
    return np.argsort(-scores, axis=-1, kind="stable")[:, :4]


def tie_masks(rng: np.random.Generator) -> list[np.ndarray]:
    """Random masks of the 57 points, and masks whose invalid points' scores
    tie: none, one, three valid points."""
    few = [np.zeros(57, bool) for _ in range(3)]
    few[1][rng.integers(57)] = True
    few[2][rng.choice(57, 3, replace=False)] = True
    return [rng.uniform(size=57) < 0.6, rng.uniform(size=57) < 0.1, *few]


def chunk_model(path: str, cls=None, **kw):
    """A port ``CoordinateModel`` on the CPU in 4-frame chunks whose temporal
    stage runs ``path``: "chunks" (the step graph's slots, stepped eagerly)
    or "frames" (the eager loop)."""
    if cls is None:
        from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel as cls
    m = cls(device="cpu", **kw)
    m.config = m.config.replace(chunk_frames=4)
    m._temporal_path = path
    return m


def osnet_params(seed: int, feature_dim: int = 512, variant: str = "x0_25"):
    """A JAX OSNet parameter pytree drawn with numpy (the shapes of
    ``eagle_tpu.models.osnet.init_params``, no eager JAX work): kernels
    normal(0, sqrt(2 / fan_in)), small random biases and random BatchNorm
    statistics (so that a bridge that drops or swaps them fails)."""
    import jax

    from eagle_tpu.models import osnet

    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: osnet.init_params(jax.random.key(0), variant, feature_dim=feature_dim))

    def draw(tree):
        if isinstance(tree, dict):
            if set(tree) == {"scale", "bias", "mean", "var"}:
                c = tuple(tree["scale"].shape)
                return {
                    "scale": rng.uniform(0.8, 1.2, c).astype(np.float32),
                    "bias": rng.normal(0.0, 0.05, c).astype(np.float32),
                    "mean": rng.normal(0.0, 0.05, c).astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, c).astype(np.float32),
                }
            return {k: draw(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v) for v in tree]
        shape = tuple(tree.shape)
        if len(shape) == 1:
            return rng.normal(0.0, 0.05, shape).astype(np.float32)
        fan_in = int(np.prod(shape[:-1]))
        return rng.normal(0.0, (2.0 / fan_in) ** 0.5, shape).astype(np.float32)

    return draw(shapes)


def flat_tree(tree, prefix: str = "") -> dict:
    """A parameter tree -> {dotted path: numpy leaf or None}: dict keys and
    list / tuple indices join with "." (so a list and flax's map keyed
    "0", "1", ... flatten alike); ``None`` leaves are kept."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_tree(v, f"{prefix}{k}."))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat_tree(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: None if tree is None else np.asarray(tree)}


def assert_trees_bit_equal(got, want) -> int:
    """Two parameter trees with the same paths, ``None`` where the other
    has ``None``, and leaves of equal dtype, shape and bytes.  Returns the
    number of array leaves."""
    g, w = flat_tree(got), flat_tree(want)
    assert sorted(g) == sorted(w), sorted(set(g) ^ set(w))[:10]
    n = 0
    for k, wv in w.items():
        gv = g[k]
        assert (gv is None) == (wv is None), k
        if wv is None:
            continue
        assert gv.dtype == wv.dtype and gv.shape == wv.shape, (k, gv.dtype, gv.shape, wv.dtype, wv.shape)
        assert np.ascontiguousarray(gv).tobytes() == np.ascontiguousarray(wv).tobytes(), k
        n += 1
    return n


_BN_REF = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def _hrnet_ref_unit(p: str) -> tuple[str, str]:
    """A port HRNet conv+BN path -> the reference's (conv, BN) module
    names (the inverse of ``convert.hrnet_from_torch``)."""
    B = "unnormalized_model.0"
    parts = p.split(".")
    if parts[0] == "stem":  # stem.conv1 -> conv1 / bn1
        return f"{B}.{parts[1]}", f"{B}.bn{parts[1][-1]}"
    if parts[0] == "layer1":
        k, c = parts[1], parts[2]
        if c == "down":
            return f"{B}.layer1.{k}.downsample.0", f"{B}.layer1.{k}.downsample.1"
        return f"{B}.layer1.{k}.{c}", f"{B}.layer1.{k}.bn{c[-1]}"
    if parts[0].startswith("transition") or parts[2] == "fuse":
        p = p.replace(".fuse.", ".fuse_layers.")
        return f"{B}.{p}.0", f"{B}.{p}.1"
    # stageS.m.branches.b.k.convI
    return f"{B}.{p}", f"{B}.{'.'.join(parts[:-1])}.bn{parts[-1][-1]}"


def hrnet_reference_state_dict(model) -> dict[str, torch.Tensor]:
    """A port HRNet module's weights as the reference's ``KeypointModel``
    state dict (``unnormalized_model.0`` the backbone, ``.1`` the head
    conv), as its ``keypoints_main.pth`` holds them."""
    out = {}
    for name, v in model.state_dict().items():
        v = v.detach().cpu().float().clone()
        if name.startswith("head."):
            out[f"unnormalized_model.1.{'weight' if name.endswith('.w') else 'bias'}"] = v
        elif name.endswith(".w"):
            conv, bn = _hrnet_ref_unit(name[:-2])
            out[f"{conv}.weight"] = v
            out[f"{bn}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
        else:
            unit, field = name.rsplit(".bn.", 1)
            out[f"{_hrnet_ref_unit(unit)[1]}.{_BN_REF[field]}"] = v
    return out


def _ultralytics_var(var: torch.Tensor) -> torch.Tensor:
    """The ultralytics running variance (BatchNorm eps 1e-3) that the
    converters turn back into ``var`` exactly: they add 1e-3 - 1e-5 in
    float32, so the nearest float32 to var - (1e-3 - 1e-5) is nudged until
    that sum rounds to ``var``."""
    from eagle_tpu_torch.models.convert import _ULTRALYTICS_BN_EPS
    from eagle_tpu_torch.models.layers import BN_EPS

    d = _ULTRALYTICS_BN_EPS - BN_EPS
    want = var.detach().cpu().numpy().astype(np.float32)
    r = (want - d).astype(np.float32)
    for _ in range(64):
        back = (r + d).astype(np.float32)
        if (back == want).all():
            return torch.from_numpy(r)
        r = np.where(back < want, np.nextafter(r, np.float32(np.inf)), r)
        r = np.where(back > want, np.nextafter(r, np.float32(-np.inf)), r).astype(np.float32)
    raise AssertionError("no float32 ultralytics variance maps back to the port's")


def _ultralytics_unit(unit: str) -> str:
    """A port YOLOv8 module path -> its ultralytics module name."""
    from eagle_tpu_torch.models.convert import _BACKBONE_MAP, _NECK_MAP

    parts = unit.split(".")
    if parts[0] == "head":  # head.levels.i.{box,cls}.j or .{box,cls}_out
        i, branch = parts[2], parts[3]
        cv = "cv2" if branch.startswith("box") else "cv3"
        return f"model.22.{cv}.{i}.{2 if branch.endswith('_out') else parts[4]}"
    index = dict(_BACKBONE_MAP) if parts[0] == "backbone" else dict(_NECK_MAP)
    return ".".join([f"model.{index[parts[1]]}", *parts[2:]])


def yolov8_ultralytics_state_dict(model) -> dict[str, torch.Tensor]:
    """A port YOLOv8 module's weights as an ultralytics state dict
    (``model.0`` .. ``model.22``, the head's ``cv2`` box and ``cv3`` class
    branches, the DFL projection), the inverse of
    ``convert.yolov8_from_torch``."""
    out = {}
    for name, v in model.state_dict().items():
        v = v.detach().cpu().float().clone()
        if ".bn." in name:
            unit, field = name.rsplit(".bn.", 1)
            ref = f"{_ultralytics_unit(unit)}.bn"
            out[f"{ref}.{_BN_REF[field]}"] = _ultralytics_var(v) if field == "var" else v
            if field == "var":
                out[f"{ref}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
            continue
        unit, field = name.rsplit(".", 1)
        ref = _ultralytics_unit(unit)
        if unit.endswith("_out"):  # the head's output convs carry a bias
            out[f"{ref}.{'weight' if field == 'w' else 'bias'}"] = v
        else:
            out[f"{ref}.conv.weight"] = v
    out["model.22.dfl.conv.weight"] = torch.arange(16, dtype=torch.float32).view(1, 16, 1, 1)
    return out


# ---------------------------------------------------------------------------
# gloo ranks for the multi-rank tests (torch and numpy only: the spawned
# workers import no JAX)
# ---------------------------------------------------------------------------


def _rank_main(rank: int, size: int, store: str, jobs, results) -> None:
    """A rank of :class:`RankPool`: joins the gloo group on ``store``, makes
    its CPU mesh, then runs ``fn(mesh, *args)`` for each job until None."""
    import datetime
    import traceback

    import torch.distributed as dist

    from eagle_tpu_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{store}", rank=rank, world_size=size, timeout=datetime.timedelta(seconds=120)
    )
    mesh = make_mesh(device="cpu")
    while True:
        job = jobs.get()
        if job is None:
            break
        fn, args = job
        try:
            results.put((rank, True, fn(mesh, *args)))
        except Exception:  # reported to the test, which fails
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``size`` gloo ranks in spawned processes on one ``file://`` store,
    fed jobs: :meth:`submit` sends ``fn`` (a module-level function of this
    module) and its arguments to every rank, :meth:`collect` returns each
    rank's ``fn(mesh, *args)`` in rank order.  The parent may work between
    the two.  A failing rank's traceback is raised and breaks the pool."""

    def __init__(self, size: int, store: str, timeout: float = 300.0):
        ctx = torch.multiprocessing.get_context("spawn")
        self.size, self.timeout, self.broken = size, timeout, False
        self.jobs = [ctx.Queue() for _ in range(size)]
        self.results = ctx.Queue()
        self.procs = [
            ctx.Process(target=_rank_main, args=(r, size, store, self.jobs[r], self.results), daemon=True)
            for r in range(size)
        ]
        for p in self.procs:
            p.start()

    def submit(self, fn, *args) -> None:
        assert not self.broken, "an earlier job failed on a rank"
        for q in self.jobs:
            q.put((fn, args))

    def collect(self) -> list:
        got = {}
        for _ in range(self.size):
            rank, ok, value = self.results.get(timeout=self.timeout)
            if not ok:
                self.broken = True
                raise RuntimeError(f"rank {rank} of {self.size} failed:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.size)]

    def run(self, fn, *args) -> list:
        self.submit(fn, *args)
        return self.collect()

    def close(self) -> None:
        for q in self.jobs:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()


def job_no_jax(mesh) -> bool:
    """Whether this rank's process has imported no JAX."""
    import sys

    return not any(m == "jax" or m.startswith(("jax.", "eagle_tpu.")) or m == "eagle_tpu" for m in sys.modules)


def job_mesh(mesh, hosts: int, x: np.ndarray) -> dict:
    """This rank's mesh on ``hosts``, and ``x`` sharded and gathered back,
    as numpy and as a tensor."""
    from eagle_tpu_torch.config import MeshConfig
    from eagle_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch

    m = make_mesh(MeshConfig(hosts=hosts), device="cpu")
    local = shard_batch(x, m)
    return dict(index=m.index, size=m.size, order=m.order, shape=m.shape, axes=m.axis_names, local=local,
                back=gather_batch(local, m), back_t=gather_batch(torch.from_numpy(local), m).numpy())


def job_halo(mesh, frames: np.ndarray) -> np.ndarray:
    """``halo_exchange_prev`` of ``frames`` sharded over the ranks, gathered."""
    from eagle_tpu_torch.parallel.mesh import gather_batch, shard_batch
    from eagle_tpu_torch.parallel.timeshard import halo_exchange_prev

    return gather_batch(halo_exchange_prev(shard_batch(torch.from_numpy(frames), mesh), mesh), mesh).numpy()


def time_inputs(frames, mem_kp, mem_valid, kp_interval: int, h_interval: int, prev=True):
    """Time-stacked ``FrameInputs`` of a clip with memoized keypoints and no
    detections (8 empty slots), ``t`` = 0..n-1 (``tests/test_timeshard.py``'s
    inputs)."""
    from eagle_tpu_torch.pipeline import temporal

    n_, d = len(frames), 8
    f = torch.from_numpy(np.ascontiguousarray(frames))
    return temporal.FrameInputs(
        frame_bgr=f,
        prev_frame_bgr=f[np.maximum(np.arange(n_) - 1, 0)] if prev else None,
        model_kp=torch.from_numpy(mem_kp),
        model_kp_valid=torch.from_numpy(mem_valid),
        is_kp_frame=np.arange(n_) % kp_interval == 0,
        is_h_frame=np.arange(n_) % h_interval == 0,
        det_boxes=torch.zeros(n_, d, 4),
        det_conf=torch.zeros(n_, d),
        det_cls=torch.zeros(n_, d, dtype=torch.int64),
        det_valid=torch.zeros(n_, d, dtype=torch.bool),
        t=np.arange(n_),
    )


def job_timeshard(mesh, cases: list) -> list:
    """:func:`timeshard_case` of each case (a tuple of its arguments)."""
    return [timeshard_case(mesh, *c) for c in cases]


def timeshard_case(mesh, frames, mem_kp, mem_valid, kp_interval: int, h_interval: int, passes: tuple,
                   sequential: bool = True):
    """``timesharded_keypoint_scan`` of the clip sharded over the ranks (the
    previous frames by ``halo_exchange_prev``) for each of ``passes``,
    gathered: ({passes: (kp_xy, kp_valid, H, H_ok)}, and with
    ``sequential``, on rank 0, ``scan_chunk`` of the whole clip)."""
    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.parallel.mesh import gather_batch, shard_batch
    from eagle_tpu_torch.parallel.timeshard import halo_exchange_prev, timesharded_keypoint_scan
    from eagle_tpu_torch.pipeline import temporal

    cfg = DEFAULT_CONFIG.replace(chunk_frames=len(frames))
    xs = time_inputs(frames, mem_kp, mem_valid, kp_interval, h_interval, prev=False)
    local = temporal.FrameInputs(*(None if v is None else shard_batch(v, mesh) for v in xs))
    local = local._replace(prev_frame_bgr=halo_exchange_prev(local.frame_bgr, mesh))
    out = {}
    for p in passes:
        res = timesharded_keypoint_scan(mesh, cfg, 0, local, passes=p)
        out[p] = tuple(gather_batch(r, mesh).numpy() for r in res)
    seq = None
    if sequential and mesh.index == 0:
        _, o = temporal.scan_chunk(temporal.init_carry(cfg, "cpu"), time_inputs(frames, mem_kp, mem_valid, kp_interval,
                                                                                 h_interval), cfg, 0)
        seq = (o.kp_xy.numpy(), o.kp_valid.numpy(), o.H.numpy(), o.H_ok.numpy())
    return out, seq


class TableDetector:
    """A detector oracle over per-clip detection tables (``tables[c]`` the
    (boxes, conf, cls, valid) arrays of clip c's frames), in the clip-major
    flattened order of ``MultiClipRunner`` with clips padded to ``L``
    frames (the cursor of ``tests/test_multiclip.py::_MultiSceneOracles``)."""

    def __init__(self, tables, L: int):
        self.tables, self.L, self.cursor = tables, L, 0

    def __call__(self, frames_batch):
        rows = []
        for k in range(len(frames_batch)):
            g = min(self.cursor + k, len(self.tables) * self.L - 1)
            ci, t_ = divmod(g, self.L)
            tab = self.tables[ci]
            t_ = min(t_, len(tab[0]) - 1)
            rows.append([a[t_] for a in tab])
        self.cursor += len(frames_batch)
        return tuple(np.stack([r[i] for r in rows]) for i in range(4))


class MarkedKeypoints:
    """A keypoint oracle: the same keypoints in every frame, withheld on the
    frames whose pixel (0, 0) is ``mark``."""

    def __init__(self, kp: np.ndarray, valid: np.ndarray, mark: np.ndarray):
        self.kp, self.valid, self.mark = kp, valid, mark

    def __call__(self, batch):
        batch = np.asarray(batch)
        valid = np.tile(self.valid, (len(batch), 1))
        valid[(batch[:, 0, 0] == self.mark).all(-1)] = False
        return np.tile(self.kp, (len(batch), 1, 1)), valid


def job_multiclip(mesh, clips, tables, kp, kp_valid, mark, fps: int, kw: dict):
    """``MultiClipRunner`` over the ranks' mesh with oracle models on
    ``clips``: every clip's dict, and this rank's on-demand rounds."""
    from eagle_tpu_torch.parallel.mesh import block
    from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel
    from eagle_tpu_torch.pipeline.multiclip import MultiClipRunner

    lo, hi = block(len(clips), mesh)
    L = max([len(c) for c in clips[lo:hi]], default=1)
    model = CoordinateModel(keypoint_fn=MarkedKeypoints(kp, kp_valid, mark), detector_fn=TableDetector(tables[lo:hi], L),
                            device="cpu")
    return MultiClipRunner(model, mesh).run(clips, fps, **kw), model.ondemand_rounds


def spread_module(model: torch.nn.Module, seed: int, gain: float = 0.5) -> torch.nn.Module:
    """Redraw a port module's weights in place from ``seed`` so activations
    carry signal (the reference init makes HRNet's heatmaps flat): every
    4-D kernel ``w`` normal(0, gain / sqrt(fan_in)), BatchNorm statistics
    random, biases ``b`` normal(0, 0.1) -- the same on every rank."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t_ in list(model.named_parameters()) + list(model.named_buffers()):
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "w" and t_.dim() == 4:
                t_.copy_(torch.randn(t_.shape, generator=gen) * (gain / (t_[0].numel()) ** 0.5))
            elif leaf in ("scale", "var"):
                t_.copy_(torch.rand(t_.shape, generator=gen) * 0.4 + 0.8)
            elif leaf in ("bias", "mean"):
                t_.copy_(torch.randn(t_.shape, generator=gen) * 0.05)
            elif leaf == "b":
                t_.copy_(torch.randn(t_.shape, generator=gen) * 0.1)
    return model


def job_sharded_steps(mesh, frames: np.ndarray, input_hw, image_size: int):
    """The frame-sharded keypoint and detector steps over the ranks,
    gathered, and on every rank the same functions on all frames at once."""
    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.config import DetectorConfig, KeypointConfig
    from eagle_tpu_torch.models.hrnet import init_hrnet
    from eagle_tpu_torch.models.yolov8 import init_yolov8
    from eagle_tpu_torch.parallel.mesh import gather_batch, shard_batch
    from eagle_tpu_torch.parallel.pipeline import sharded_detector_step, sharded_keypoint_step

    cfg = DEFAULT_CONFIG.replace(keypoint=KeypointConfig(input_hw=tuple(input_hw), use_bf16=False),
                                 detector=DetectorConfig(image_size=image_size, max_detections=16, use_bf16=False))
    hw = frames.shape[1:3]
    hrnet = spread_module(init_hrnet(0), 1).eval()
    yolo = spread_module(init_yolov8(1, "n"), 2, gain=1.0).eval()
    kstep = sharded_keypoint_step(mesh, hrnet, cfg, hw)
    dstep = sharded_detector_step(mesh, yolo, cfg, hw, variant="n")
    local = shard_batch(frames, mesh)
    return dict(sharded=[gather_batch(r, mesh).numpy() for r in (*kstep(local), *dstep(local))],
                single=[r.numpy() for r in (*kstep(frames), *dstep(frames))])


def job_clip_scan(mesh, hosts: int, xs, seed: int, packed: bool, derive_prev: bool = True):
    """``multi_clip_scan`` over a mesh on ``hosts`` of clip-stacked inputs
    (numpy leaves, ``xs`` a dict of FrameInputs fields): every clip's
    outputs."""
    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.config import MeshConfig
    from eagle_tpu_torch.parallel.mesh import make_mesh
    from eagle_tpu_torch.parallel.pipeline import multi_clip_scan
    from eagle_tpu_torch.pipeline import temporal

    cfg = clip_scan_config(DEFAULT_CONFIG)
    m = make_mesh(MeshConfig(hosts=hosts), device="cpu")
    x = temporal.FrameInputs(**{k: torch.from_numpy(v) if k not in ("is_kp_frame", "is_h_frame", "t") else v
                                for k, v in xs.items()})
    c = len(xs["t"])
    carries = temporal.stack_clips([temporal.init_carry(cfg, "cpu") for _ in range(c)])
    _, out = multi_clip_scan(m, cfg, seed, derive_prev=derive_prev, packed=packed)(carries, x)
    return out


def clip_scan_config(cfg):
    """The configuration of ``tests/test_parallel.py``'s clip scan: 8
    detection slots."""
    import dataclasses

    return cfg.replace(detector=dataclasses.replace(cfg.detector, max_detections=8))


def job_timeshard_on(mesh, hosts: int) -> list:
    """The errors ``halo_exchange_prev`` and ``timesharded_keypoint_scan``
    raise on a mesh over ``hosts`` (both refuse a 2-D mesh)."""
    from eagle_tpu_torch import DEFAULT_CONFIG
    from eagle_tpu_torch.config import MeshConfig
    from eagle_tpu_torch.parallel.mesh import make_mesh
    from eagle_tpu_torch.parallel.timeshard import halo_exchange_prev, timesharded_keypoint_scan

    m = make_mesh(MeshConfig(hosts=hosts), device="cpu")
    errors = []
    for call in (lambda: halo_exchange_prev(torch.zeros(2, 4, 4, 3, dtype=torch.uint8), m),
                 lambda: timesharded_keypoint_scan(m, DEFAULT_CONFIG, 0, None)):
        try:
            call()
        except ValueError as e:
            errors.append(str(e))
    return errors


def gloo_card_rank(rank: int, size: int, store: str, out_dir: str) -> None:
    """A rank of the card test of gloo's host transport (spawned by
    ``torch.multiprocessing.spawn``; every rank on the one card): the ring
    shift, the halo exchange and ``gather_batch`` of CUDA tensors, saved to
    ``out_dir/rank<r>.pt`` as CPU tensors."""
    import datetime

    import torch.distributed as dist

    from eagle_tpu_torch.parallel.mesh import gather_batch, make_mesh, shard_batch, shift_right
    from eagle_tpu_torch.parallel.timeshard import halo_exchange_prev

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh()
        assert mesh.device.type == "cuda" and mesh.backend == "gloo"
        frames = torch.arange(8 * 4 * 6 * 3, dtype=torch.int64).remainder(251).to(torch.uint8).reshape(8, 4, 6, 3)
        local = shard_batch(frames.to(mesh.device), mesh)
        (got,) = shift_right([torch.full((3,), rank, dtype=torch.float32, device=mesh.device)], mesh)
        torch.save(dict(shift=got.cpu(), shift_device=str(got.device),
                        halo=gather_batch(halo_exchange_prev(local, mesh), mesh).cpu(),
                        gather=gather_batch(local, mesh).cpu()), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
