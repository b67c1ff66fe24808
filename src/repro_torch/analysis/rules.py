"""The contract checker: declarative rules over one serving step, run once
eagerly under the port's recorders.

The reference traces and compiles each step and walks its jaxpr and HLO
(``repro.analysis.rules``).  The port has no trace: :func:`audit_step`
runs the step once and reads what the port already records —
``engine.dispatch_trace()`` (through the op walker's chained listener),
``engine.launch_counts()``, ``comm.collective_counts()``,
``tuning.stats()`` — and the :mod:`~repro_torch.analysis.op_walker`'s aten
log.  The rule ids follow the reference's where the contract carries over:

  ========================================  =================================
  reference id -> port id                   port contract
  ========================================  =================================
  no_collectives                            a pure-DP step's
                                            ``collective_counts()`` delta is
                                            zero
  pallas_call_present ->                    every kernel-bearing dispatch
  cuda_kernel_launched                      (quantized ``qmatmul``, the
                                            attention kernels, the row
                                            quantizer) has ``impl_backend
                                            == "cuda"`` and
                                            ``launch_counts()`` moved for
                                            its kernel (the fused decode's:
                                            B4, or B2 where a quantized
                                            ``wo`` composes B2 and
                                            ``qmatmul``); a quantized step
                                            with no ``qmatmul`` event fires
  no_f32_upcast_of_quantized_operands       no op-walker path leads from
                                            int8-family codes to a float
                                            matmul outside a kernel
  scale_shape_is_per_row                    as the reference, on the
                                            ``qmatmul`` events'
                                            ``a_scale_shape``: (M, 1)
  cache_donated ->                          every cache / pool leaf keeps
  cache_updated_in_place                    its ``data_ptr`` across the
                                            step, and the step returns it
  tuning_cache_hit                          as the reference: the
                                            ``tuning.stats()`` delta has no
                                            miss and no sweep
  fused_decode_single_dispatch              a paged fp32-``wo`` decode step
                                            dispatches (on the card:
                                            launches) B4 once a layer and no
                                            B2 / B5 / B8; the op walker
                                            records no host sync in it
  ========================================  =================================

Exempt from the two kernel rules, by their dispatch events (as the
reference exempts kind ``codes``), never by matching names: ``qmatmul`` of
kind ``codes`` (the unpacked int8 storage), and the dispatches that have
no kernel in either package — ``qmatmul_experts``, ``ssm_scan``, the dense
kv4 ``decode_attention``.  An upcast whose root ran inside a dispatch that
ran a plain version (``impl_backend == "torch"``) is that dispatch's
``cuda_kernel_launched`` finding, reported once, there.

``cuda_kernel_launched`` and ``no_f32_upcast_of_quantized_operands`` bind
only on the card (``report.CARD_ONLY_RULES``): on a host device every
dispatch runs its plain version.  :func:`audit_step` reports them as not
bound there, never as passed.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves

from .report import Finding, StepSpec

# dispatch op (and qmatmul kind) -> the kernels whose launch counter one
# such dispatch moves: the fused decode runs B4, or with a quantized wo
# the engine's composition of B2 and qmatmul (whose own event names B1)
_QMATMUL_KERNEL = {"ternary": ("ternary_matmul",), "int": ("packed_matmul",),
                   "binary": ("binary_matmul",)}
_OP_KERNEL = {"decode_attention": ("decode_attention",),
              "paged_attention": ("paged_attention",),
              "fused_paged_decode": ("fused_decode", "paged_attention"),
              "flash_attention": ("flash_attention",),
              "act_quant_signed_grouped": ("act_quant_signed_grouped",)}
_ATTENTION_OPS = ("decode_attention", "paged_attention", "flash_attention")


def exempt(ev) -> bool:
    """A dispatch with no kernel by design (either package)."""
    return (ev.op == "qmatmul" and ev.kind == "codes") or \
        ev.op in ("qmatmul_experts", "ssm_scan") or \
        (ev.op == "decode_attention" and ev.a_bits == 4)


def kernel_of(ev) -> tuple[str, ...] | None:
    """The launch counters of the kernels ``ev`` may have run, one of
    which must move (None for an exempt dispatch or one that names no
    kernel)."""
    if exempt(ev):
        return None
    if ev.op == "qmatmul":
        return _QMATMUL_KERNEL.get(ev.kind)
    return _OP_KERNEL.get(ev.op)


def _ptrs(tree) -> list[int]:
    return [t.data_ptr() for t in tree_leaves(tree)]


class StepArtifacts:
    """What one run of a step leaves: its dispatch events, the launch,
    collective and tuning deltas, the op log and the in-place check's
    storage pointers.  Built by :meth:`run`, or given directly (a test feeds
    recorded events and op logs)."""

    def __init__(self, spec: StepSpec, *, events=None, launches=None,
                 collectives=None, tuning_delta=None, op_log=None,
                 inplace=None):
        self.spec = spec
        self.events = list(events or [])
        self.launches = dict(launches or {})
        self.collectives = dict(collectives or {})
        self.tuning_delta = dict(tuning_delta or {})
        self.op_log = op_log
        # argnum -> (pointers before, pointers after, returned pointers)
        self.inplace = dict(inplace or {})

    @classmethod
    def run(cls, spec: StepSpec) -> "StepArtifacts":
        from repro_torch.kernels import engine, tuning
        from repro_torch.parallel import comm
        from .op_walker import OpWalker
        before = {i: _ptrs(spec.args[i]) for i in spec.inplace}
        launches0 = engine.launch_counts()
        coll0 = comm.collective_counts()
        tune0 = tuning.stats()
        kw = {} if spec.run_backend is None else \
            {"backend": spec.run_backend}
        with torch.no_grad(), OpWalker() as w:
            out = spec.fn(*spec.args, **kw)
        launches = {k: v - launches0.get(k, 0)
                    for k, v in engine.launch_counts().items()}
        coll = {k: v - coll0.get(k, 0)
                for k, v in comm.collective_counts().items()}
        tune = {k: v - tune0.get(k, 0) for k, v in tuning.stats().items()}
        inplace = {}
        for i in spec.inplace:
            ret = _returned_like(out, spec.args[i])
            inplace[i] = (before[i], _ptrs(spec.args[i]),
                          None if ret is None else _ptrs(ret))
        return cls(spec, events=w.log.events, launches=launches,
                   collectives=coll, tuning_delta=tune, op_log=w.log,
                   inplace=inplace)


def _returned_like(out, arg):
    """The element of the step's output with ``arg``'s tree structure (the
    returned cache or pool), else None."""
    cands = out if isinstance(out, (tuple, list)) else (out,)
    n = len(tree_leaves(arg))
    for c in cands:
        if isinstance(c, dict) and sorted(c) == sorted(arg) and \
                len(tree_leaves(c)) == n:
            return c
    return None


def _rule_no_collectives(art: StepArtifacts) -> list[Finding]:
    made = {k: v for k, v in art.collectives.items() if v}
    if not made:
        return []
    return [Finding(rule="no_collectives", step=art.spec.name,
                    message=f"pure-DP step made {n} {op} collective(s)",
                    locus=f"collective_counts delta: {made}")
            for op, n in sorted(made.items())]


def _rule_cuda_kernel_launched(art: StepArtifacts) -> list[Finding]:
    out = []
    kernels = [(e, kernel_of(e)) for e in art.events]
    kernels = [(e, k) for e, k in kernels if k is not None]
    for e, k in kernels:
        if e.impl_backend != "cuda":
            out.append(Finding(
                rule="cuda_kernel_launched", step=art.spec.name,
                message=f"{e.op} dispatched the {e.impl_backend!r} impl "
                        f"for kind={e.kind} a{e.a_bits}w{e.w_bits} "
                        f"(requested {e.requested_backend!r}) in place of "
                        f"the {' / '.join(k)} kernel",
                locus=f"dispatch m={e.m_rows} block={e.block}"))
    for k in sorted({k for e, k in kernels if e.impl_backend == "cuda"}):
        if not any(art.launches.get(name, 0) for name in k):
            out.append(Finding(
                rule="cuda_kernel_launched", step=art.spec.name,
                message=f"dispatches named the cuda impl but the "
                        f"{' / '.join(k)} kernel's launch count did not "
                        "move",
                locus=f"launch_counts delta: {art.launches}"))
    if not any(e.op == "qmatmul" for e in art.events):
        out.append(Finding(
            rule="cuda_kernel_launched", step=art.spec.name,
            message="no qmatmul dispatch events recorded — the step never "
                    "reached the kernel engine"))
    return out


def _rule_no_upcast(art: StepArtifacts) -> list[Finding]:
    out = []
    log = art.op_log
    for u in (log.upcasts if log is not None else ()):
        ev = None if u.root.event is None else art.events[u.root.event]
        if ev is not None and (exempt(ev) or ev.impl_backend != "cuda"):
            continue
        where = "outside every engine dispatch" if ev is None else \
            f"inside the cuda {ev.op} dispatch (kind={ev.kind})"
        out.append(Finding(
            rule="no_f32_upcast_of_quantized_operands", step=art.spec.name,
            message=f"{u.root.src_dtype} codes converted to "
                    f"{u.root.dst_dtype} and consumed by {u.op} {where}",
            locus=f"op #{u.root.op_index} -> op #{u.op_index}"))
    return out


def _rule_scale_per_row(art: StepArtifacts) -> list[Finding]:
    out = []
    for e in art.events:
        if e.op != "qmatmul" or e.a_scale_shape is None:
            continue
        if tuple(e.a_scale_shape) != (e.m_rows, 1):
            out.append(Finding(
                rule="scale_shape_is_per_row", step=art.spec.name,
                message=f"activation scale has shape {e.a_scale_shape} for "
                        f"M={e.m_rows} local rows — expected per-row "
                        f"({e.m_rows}, 1)",
                locus=f"dispatch kind={e.kind} a{e.a_bits}w{e.w_bits}"))
    return out


def _rule_cache_in_place(art: StepArtifacts) -> list[Finding]:
    out = []
    for i, (before, after, returned) in sorted(art.inplace.items()):
        moved = sum(a != b for a, b in zip(before, after))
        if moved:
            out.append(Finding(
                rule="cache_updated_in_place", step=art.spec.name,
                message=f"{moved} of {len(before)} leaves of argument {i} "
                        "were replaced by new storage"))
        if returned is None:
            out.append(Finding(
                rule="cache_updated_in_place", step=art.spec.name,
                message=f"the step returned no tree shaped as argument {i}"))
        elif returned != before:
            n = sum(a != b for a, b in zip(before, returned))
            out.append(Finding(
                rule="cache_updated_in_place", step=art.spec.name,
                message=f"the returned tree of argument {i} holds {n} "
                        f"leaves of new storage (of {len(before)})"))
    return out


def _rule_tuning_cache_hit(art: StepArtifacts) -> list[Finding]:
    d = art.tuning_delta
    if d.get("misses", 0) == 0 and d.get("sweeps", 0) == 0:
        return []
    return [Finding(
        rule="tuning_cache_hit", step=art.spec.name,
        message=f"{d.get('misses', 0)} tuning-cache miss(es) and "
                f"{d.get('sweeps', 0)} sweep(s) in the step — per-shard "
                "shape classes are not covered by the cache",
        locus=f"stats delta: {d}")]


def _rule_fused_decode_single_dispatch(art: StepArtifacts) -> list[Finding]:
    spec = art.spec
    n_layers = int(spec.fused_layers or 0)
    out = []
    fused = sum(e.op == "fused_paged_decode" for e in art.events)
    other = sorted({e.op for e in art.events if e.op in _ATTENTION_OPS})
    if fused != n_layers:
        out.append(Finding(
            rule="fused_decode_single_dispatch", step=spec.name,
            message=f"expected one fused-decode dispatch per layer "
                    f"({n_layers}), recorded {fused} — the decode step is "
                    "not on the fused path"))
    if other:
        out.append(Finding(
            rule="fused_decode_single_dispatch", step=spec.name,
            message="non-fused attention dispatch(es) in the decode step — "
                    "attention + projection must be one dispatch a layer",
            locus=", ".join(other)))
    if spec.on_card:
        got = {k: art.launches.get(k, 0) for k in
               ("fused_decode", "paged_attention", "decode_attention",
                "flash_attention")}
        if got != {"fused_decode": n_layers, "paged_attention": 0,
                   "decode_attention": 0, "flash_attention": 0}:
            out.append(Finding(
                rule="fused_decode_single_dispatch", step=spec.name,
                message=f"expected {n_layers} B4 launches and no B2 / B5 / "
                        f"B8, launched {got}"))
    syncs = art.op_log.syncs if art.op_log is not None else []
    if syncs:
        out.append(Finding(
            rule="fused_decode_single_dispatch", step=spec.name,
            message=f"{len(syncs)} host sync(s) in the decode step — the "
                    "fused path must not wait on the host mid-step",
            locus="; ".join(sorted(set(syncs))[:3])))
    return out


RULES = {
    "no_collectives": _rule_no_collectives,
    "cuda_kernel_launched": _rule_cuda_kernel_launched,
    "no_f32_upcast_of_quantized_operands": _rule_no_upcast,
    "scale_shape_is_per_row": _rule_scale_per_row,
    "cache_updated_in_place": _rule_cache_in_place,
    "tuning_cache_hit": _rule_tuning_cache_hit,
    "fused_decode_single_dispatch": _rule_fused_decode_single_dispatch,
}

# the reference's rule ids, by the port's
REFERENCE_IDS = {r: r for r in RULES}
REFERENCE_IDS.update({"cuda_kernel_launched": "pallas_call_present",
                      "cache_updated_in_place": "cache_donated"})


def check(art: StepArtifacts, rules) -> list[Finding]:
    """The findings of ``rules`` on recorded artifacts."""
    findings: list[Finding] = []
    for name in rules:
        findings.extend(RULES[name](art))
    return findings


def audit_step(spec: StepSpec, rules=None) -> tuple[list[Finding], dict]:
    """Check one serving step against its contracts: run it once, then
    apply ``rules`` (default: :meth:`StepSpec.default_rules`; unknown ids
    raise).  Returns (findings, {"rules": bound, "not_bound": card-only
    rules off the card}); empty findings mean every bound contract holds."""
    names = tuple(rules) if rules is not None else spec.default_rules()
    unknown = [r for r in names if r not in RULES]
    if unknown:
        raise KeyError(f"unknown rule(s) {unknown}; known: {sorted(RULES)}")
    bound, not_bound = spec.split_rules(names)
    findings = check(StepArtifacts.run(spec), bound)
    return findings, {"rules": list(bound), "not_bound": list(not_bound)}
