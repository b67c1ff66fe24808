"""forward_mfu (%): the whole forward's share of the card's int8 peak.

The model's operations an image (2 x MACs of every layer, the f32 head
included, from the configuration's shapes) times the images a second of
the run's measured window, over 1,979 TOP/s (``costs.PEAK_INT8_OPS``, the
dense int8 rate that B1's ``mma.sync`` s8 runs at).  It bounds every
kernel's share: a kernel taken off the path leaves its roofline silent,
and this still counts the forward."""
from __future__ import annotations

import costs


def read(run):
    if run.images_per_s <= 0:
        return None
    per_image = costs.model_ops(run.layers) / run.batch
    return 100.0 * per_image * run.images_per_s / costs.PEAK_INT8_OPS
