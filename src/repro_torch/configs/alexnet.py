"""AlexNet — the paper's own proof-of-concept topology (§IV.B).

1.44 GOPs/image baseline; the paper ran the 2-bit-activation x
ternary-weight (2xT) variant on an Arria 10 FPGA.  Conv stack per
Krizhevsky (single-tower variant), with BNS blocks replacing LRN (paper
§III.A).  Channels widen 1x/2x/3x per WRPN.  ``models.cnn.alexnet_init``
builds it.
"""

# (kind, out_channels, kernel, stride, pad) — widened channels exclude first conv
ALEXNET_LAYERS = [
    ("conv", 64, 11, 4, 2),
    ("pool", 0, 3, 2, 0),
    ("conv", 192, 5, 1, 2),
    ("pool", 0, 3, 2, 0),
    ("conv", 384, 3, 1, 1),
    ("conv", 256, 3, 1, 1),
    ("conv", 256, 3, 1, 1),
    ("pool", 0, 3, 2, 0),
    ("fc", 4096, 0, 0, 0),
    ("fc", 4096, 0, 0, 0),
    ("fc", 1000, 0, 0, 0),
]

INPUT_SHAPE = (224, 224, 3)
GOPS_PER_IMAGE = 1.44        # paper §IV.A
