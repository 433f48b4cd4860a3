"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W power limit); a roofline share is stated against these, with
the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12        # float32 outside the tensor cores (TF32 off)
