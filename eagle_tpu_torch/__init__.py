"""eagle_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of eagle_tpu.

The JAX package ``eagle_tpu`` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs.  Its
layout mirrors the reference so that each counterpart is easy to find:

- :mod:`eagle_tpu_torch.config`, :mod:`eagle_tpu_torch.pitch` -- static
  configuration and pitch geometry (copies);
- :mod:`eagle_tpu_torch.native` -- the host C++ prescales (4:2:0 and BGR
  letterboxes, BGR -> I420) and crop resize;
- :mod:`eagle_tpu_torch.ops` -- tensor ops, and the four hand-written
  CUDA kernels: ``csrc/lk_flow.cu`` (Lucas-Kanade optical flow, behind
  :func:`eagle_tpu_torch.ops.optical_flow.lk_flow`), ``csrc/lap_jv.cu``
  (the exact JV assignment, :func:`eagle_tpu_torch.ops.assignment.solve_lap`),
  ``csrc/auction.cu`` (the tracker's auction rounds,
  :func:`eagle_tpu_torch.ops.assignment.auction_rounds`) and ``csrc/nms.cu``
  (NMS's suppression fixed point, :func:`eagle_tpu_torch.ops.nms.suppress`);
- :mod:`eagle_tpu_torch.models` -- HRNet-W48, YOLOv8 and the OSNet-x0.25
  ReID network as ``nn.Module``s, the weight bridge from the JAX
  parameter pytrees, and the checkpoint loaders (torch state dicts,
  ``.onnx``, ``.msgpack``);
- :mod:`eagle_tpu_torch.track` -- the BoT-SORT tracker, with appearance
  association;
- :mod:`eagle_tpu_torch.pipeline` -- the temporal step (and its
  clip-batched form), ``CoordinateModel.get_coordinates`` and
  ``stream_coordinates``, ``MultiClipRunner``, the ``Processor`` and
  ``serve_clips``;
- :mod:`eagle_tpu_torch.io` -- the JSON writers, and video decode and
  encode, which import OpenCV only when called (nothing imports it at
  import time);
- :mod:`eagle_tpu_torch.evaluate`, :mod:`eagle_tpu_torch.validate_acceptance`
  -- the eval CLI (``results.json``) and the acceptance runner, scored on
  the OpenCV-free synthetic scene of :mod:`eagle_tpu_torch.utils.synthetic`.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""

from eagle_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig

__version__ = "0.1.0"

__all__ = ["DEFAULT_CONFIG", "PipelineConfig", "CoordinateModel", "Processor", "__version__"]


def __getattr__(name):
    # lazy top-level API (importing the pipeline pulls in the full op stack)
    if name == "CoordinateModel":
        from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

        return CoordinateModel
    if name == "Processor":
        from eagle_tpu_torch.pipeline.processor import Processor

        return Processor
    raise AttributeError(name)
