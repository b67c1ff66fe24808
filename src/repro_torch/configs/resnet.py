"""ResNet-34 / ResNet-50 — the paper's Stratix 10 projection topologies
(§IV.C).

Standard He et al. configurations; widening (2x/3x) multiplies the block
channel counts per WRPN.  GOPs are the published per-image multiply-add
counts x2.  ``models.cnn.resnet_init`` builds them.
"""

RESNET34 = {
    "name": "resnet34",
    "block": "basic",
    "stages": [(64, 3), (128, 4), (256, 6), (512, 3)],
    "gops_per_image": 7.2,       # ~3.6 GMACs
}

RESNET50 = {
    "name": "resnet50",
    "block": "bottleneck",
    "stages": [(64, 3), (128, 4), (256, 6), (512, 3)],
    "gops_per_image": 8.2,       # ~4.1 GMACs
}

INPUT_SHAPE = (224, 224, 3)
