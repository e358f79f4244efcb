"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit); a share is stated against them with the
card's power limit beside it."""

#: bfloat16 tensor-core FLOP/s, dense
BF16_FLOPS = 989e12
#: HBM bytes/s
HBM_BYTES = 3.35e12
#: float32 instructions/s outside the tensor cores: a multiply, an add or a
#: fused multiply-add each one instruction a lane a cycle, 132 SMs x 128
#: lanes x 1.98 GHz (the sheet's 67 TFLOP/s counts an FMA as two)
F32_INSTR = 33.5e12
