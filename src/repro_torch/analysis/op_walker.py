"""The op walker: a ``TorchDispatchMode`` recorder, the port's counterpart
of ``repro.analysis.jaxpr_walker``.

The reference traces a step to a jaxpr and walks it; the port runs the
step once, eagerly, under :class:`OpWalker`, which sees every aten op that
passes through PyTorch's dispatcher and logs:

  * the aten ops run, in order (:attr:`OpLog.ops`);
  * a dtype dataflow: a tensor converted from an int8-family dtype to a
    float dtype is a root, followed through views, copies and elementwise
    ops by a scalar to a float matmul (``mm`` / ``bmm`` / ``addmm``, the
    forms ``matmul``, ``einsum`` and ``linear`` reach): each such
    consumer is an :class:`Upcast`.  An elementwise op with an array
    co-operand (a per-position KV scale, say) ends the chain, as the
    reference's walk ends it;
  * host syncs: ``aten._local_scalar_dense`` (``.item()``, ``int()`` of a
    tensor) and device-to-host copies.

Ops inside the port's compiled kernels do not pass through aten: that is
what "inside a kernel" means here, as a ``pallas_call``'s body is for the
reference.  Each root is attributed to the engine dispatch it ran in, if
any: the walker chains itself to the engine's dispatch listener to log
the run's events (:class:`~repro_torch.kernels.engine.DispatchEvent`), and a
root converted while ``engine.active_dispatch()`` names one of them ran
inside that dispatch (its plain version, or its epilogue): the engine
marks each dispatch's work as running for the ``with`` block of its
dispatch site.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakTensorKeyDictionary

SMALL_INT = (torch.int8, torch.uint8)
# ops whose outputs carry their (single tensor) input's values
_PASS = {"view", "_unsafe_view", "reshape", "_reshape_alias", "t",
         "transpose", "permute", "expand", "squeeze", "unsqueeze", "slice",
         "select", "clone", "contiguous", "alias", "detach", "_to_copy",
         "copy", "lift_fresh", "unbind", "split", "split_with_sizes",
         "chunk", "as_strided", "narrow", "flatten", "unflatten",
         "index_select", "embedding", "cat", "stack"}
# elementwise ops that keep provenance when the co-operand is a scalar
_SCALE = {"mul", "add", "sub", "div", "neg"}
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "dot", "mv",
           "matmul", "linear"}
_SYNC = "_local_scalar_dense"


@dataclass
class Root:
    """An int8-family tensor converted to a float dtype: the op index and
    the dispatch it ran in (an index into the step's events, or None
    outside every engine dispatch)."""
    op_index: int
    src_dtype: str
    dst_dtype: str
    event: int | None


@dataclass
class Upcast:
    """A float matmul fed by a converted int8-family tensor."""
    op: str
    op_index: int
    root: Root


@dataclass
class OpLog:
    ops: list[str] = field(default_factory=list)
    upcasts: list[Upcast] = field(default_factory=list)
    syncs: list[str] = field(default_factory=list)
    events: list = field(default_factory=list)


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_scalar(v) -> bool:
    return not isinstance(v, torch.Tensor) or v.dim() == 0


class OpWalker(TorchDispatchMode):
    """Run a step under ``with OpWalker() as w:``; then ``w.log``.  The
    engine's dispatch events of the run are in ``log.events`` (in order);
    a listener installed before is called as well."""

    def __init__(self):
        super().__init__()
        self.log = OpLog()
        self._taint = WeakTensorKeyDictionary()
        self._index: dict[int, int] = {}     # id(event) -> its index
        self._prev_listener = None

    # ---- the engine's dispatch events, in order
    def _on_event(self, ev) -> None:
        self._index[id(ev)] = len(self.log.events)
        self.log.events.append(ev)
        if self._prev_listener is not None:
            self._prev_listener(ev)

    def __enter__(self):
        from repro_torch.kernels import engine
        self._prev_listener = engine._DISPATCH_LISTENER
        engine.set_dispatch_listener(self._on_event)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import engine
        engine.set_dispatch_listener(self._prev_listener)
        return super().__exit__(*exc)

    def _running_dispatch(self) -> int | None:
        """The index of the engine dispatch whose work is running now."""
        from repro_torch.kernels import engine
        ev = engine.active_dispatch()
        return None if ev is None else self._index.get(id(ev))

    # ---- every aten op
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__.rstrip("_")
        idx = len(self.log.ops)
        self.log.ops.append(str(func.overloadpacket))
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if name == _SYNC:
            self.log.syncs.append(f"{func} on {ins[0].device}")
        elif name in ("_to_copy", "copy") and ins:
            src = ins[-1] if name == "copy" else ins[0]
            dst = ins[0] if name == "copy" else (outs[0] if outs else None)
            if dst is not None and src.device.type == "cuda" \
                    and dst.device.type == "cpu":
                self.log.syncs.append(f"{func} cuda -> cpu")
        tainted = [self._taint[t] for t in ins if t in self._taint]
        root = tainted[0] if tainted else None
        if name in _MATMUL and root is not None and any(
                t in self._taint and t.is_floating_point() for t in ins):
            self.log.upcasts.append(Upcast(str(func.overloadpacket), idx,
                                           root))
        if name in ("_to_copy", "copy") and ins and outs:
            src = ins[-1] if name == "copy" else ins[0]
            if src.dtype in SMALL_INT and outs[0].is_floating_point():
                root = Root(idx, str(src.dtype), str(outs[0].dtype),
                            self._running_dispatch())
        carries = name in _PASS or (
            name in _SCALE and all(_is_scalar(a) for a in args
                                   if not (isinstance(a, torch.Tensor)
                                           and a in self._taint)))
        if root is not None and (carries or root.op_index == idx):
            for t in outs:
                if t.is_floating_point():
                    self._taint[t] = root
        return out


def walk(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpWalker`;
    returns (its output, the :class:`OpLog`)."""
    with OpWalker() as w:
        out = fn(*args, **kwargs)
    return out, w.log
