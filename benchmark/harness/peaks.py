"""Published peaks of the card the benchmark targets: one NVIDIA H100 SXM
(80 GB HBM3), dense rates, at its full 700 W power limit (NVIDIA H100
data sheet). A roofline share states the card's power limit beside it."""

HBM_BYTES_PER_S = 3.35e12
