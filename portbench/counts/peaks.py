"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit and the 1.98 GHz boost clock)."""

BF16_FLOPS = 989e12  # bf16 tensor-core FLOP/s, dense
HBM_BYTES_PER_S = 3.35e12
SMS = 132
CLOCK_HZ = 1.98e9
# Each SM issues 128 thread-instructions a clock (the data sheet's 67 TFLOP/s
# in float32 counts an FMA as two); its special-function units (MUFU: exp2,
# log2, sin, cos, rsqrt, rcp) do 16 a clock.
INSTRUCTIONS_PER_S = SMS * 128 * CLOCK_HZ
MUFU_PER_S = SMS * 16 * CLOCK_HZ
