"""eagle_tpu_torch: the PyTorch / CUDA (NVIDIA Hopper) port of eagle_tpu.

The JAX package ``eagle_tpu`` stays the reference; this package imports
nothing of it (nor JAX) and keeps its own copies of what it needs.  Its
layout mirrors the reference so that each counterpart is easy to find:

- :mod:`eagle_tpu_torch.config`, :mod:`eagle_tpu_torch.pitch` -- static
  configuration and pitch geometry (copies);
- :mod:`eagle_tpu_torch.native` -- the host C++ prescales (4:2:0 and BGR
  letterboxes, BGR -> I420) and crop resize;
- :mod:`eagle_tpu_torch.ops` -- tensor ops, and the one hand-written CUDA
  kernel (``csrc/lk_flow.cu``, Lucas-Kanade optical flow) behind
  :func:`eagle_tpu_torch.ops.optical_flow.lk_flow`;
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
- :mod:`eagle_tpu_torch.io` -- video decode and encode (OpenCV), the
  JSON writers.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; without a card they raise rather than fall back.
"""

from eagle_tpu_torch.config import DEFAULT_CONFIG, PipelineConfig

__version__ = "0.1.0"

__all__ = ["DEFAULT_CONFIG", "PipelineConfig", "CoordinateModel", "__version__"]


def __getattr__(name):
    if name == "CoordinateModel":
        from eagle_tpu_torch.pipeline.coordinate_model import CoordinateModel

        return CoordinateModel
    raise AttributeError(name)
