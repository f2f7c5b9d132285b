"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet,
dense rates, at the full 700 W power limit). A roofline share is stated
against these, with the card's power limit read beside it."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
