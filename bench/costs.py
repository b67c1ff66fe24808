"""The yardstick's work counts and the card's peaks.

A frozen copy, kept with the benchmark so that a change to the program
cannot change what it is measured against.  ``repro_torch.kernels.costs``
is the port's own (its matmul counts the im2col patches and the f32
accumulators); these count the work that any implementation of a layer
must do:

- operations: ``2 * M * N * K`` a product (M = output positions x batch);
- bytes: the layer's input feature map as int8 codes, its weight packed at
  its bit width, and its output feature map as int8 codes, each once.
  Not the im2col patches and not f32 accumulators, so a kernel that fuses
  im2col, the quantizer or the BNS chain into the product can not read
  over its roofline.

The head of a CNN stays float (f32): its operations count in the model's
operations (``forward_mfu``), and it is no quantized layer.
"""
from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates, 700 W
PEAK_INT8_OPS = 1979e12          # int8 tensor cores, operations/s
PEAK_HBM_BYTES = 3.35e12         # HBM3, bytes/s


@dataclasses.dataclass(frozen=True)
class Layer:
    """One product of a forward: ``(m, k) @ (k, n)``.

    ``in_elems`` is the element count of the layer's input feature map
    (before im2col), ``w_bits`` the width of its stored weight (2 for
    ternary; 32 for the f32 head), ``quantized`` whether the layer runs on
    quantized activations and weights."""
    name: str
    m: int
    n: int
    k: int
    in_elems: int
    w_bits: int
    quantized: bool


def ops(layer: Layer) -> int:
    return 2 * layer.m * layer.n * layer.k


def min_bytes(layer: Layer) -> float:
    """Input map as int8 codes, the packed weight, output map as int8."""
    return layer.in_elems + layer.k * layer.n * layer.w_bits / 8 + \
        layer.m * layer.n


def bound_s(layer: Layer) -> float:
    """The least time the card could take: operations at the int8 peak or
    bytes at the HBM peak, whichever is longer."""
    return max(ops(layer) / PEAK_INT8_OPS, min_bytes(layer) / PEAK_HBM_BYTES)


def model_ops(layers: list[Layer]) -> int:
    """2 x MACs of every layer, the head included."""
    return sum(ops(x) for x in layers)


def out_size(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def conv(name: str, batch: int, h: int, w: int, c_in: int, c_out: int,
         kernel: int, stride: int, pad: int, w_bits: int = 2
         ) -> tuple[Layer, int, int]:
    """A quantized conv over a (batch, h, w, c_in) map: the layer and its
    output's height and width."""
    p, q = out_size(h, kernel, stride, pad), out_size(w, kernel, stride, pad)
    layer = Layer(name, batch * p * q, c_out, kernel * kernel * c_in,
                  batch * h * w * c_in, w_bits, True)
    return layer, p, q


def dense(name: str, batch: int, k: int, n: int, w_bits: int = 2,
          quantized: bool = True) -> Layer:
    """A fully connected layer on ``batch`` rows of ``k`` features."""
    return Layer(name, batch, n, k, batch * k, w_bits, quantized)
