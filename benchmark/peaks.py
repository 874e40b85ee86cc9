"""Published peaks of the card the benchmark runs on: one NVIDIA H100 SXM
(NVIDIA's data sheet, at its 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
# int32 operations a second outside the tensor cores, as the repository's
# kernel table counts them
INT32_OPS_PER_S = 33.5e12
