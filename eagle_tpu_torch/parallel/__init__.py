"""Multi-device runs over torch.distributed: one process per rank (SPMD),
NCCL between cards, gloo between CPU processes (counterpart of
``eagle_tpu/parallel``)."""
