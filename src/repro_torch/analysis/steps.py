"""The audit cell matrix: which {config, precision, serving form, mesh}
combinations the auditor runs, and how (``repro.analysis.steps``).

A *cell* is one batcher construction (model config + precision +
dense/paged serving form + optional speculation) audited on a list of
mesh shapes.  :func:`audit_cell` builds the cell's batcher on one mesh,
primes the tuning cache (default tiles, no measuring — ``tuning_cache_hit``
checks that the keys are covered), enumerates its ``audit_steps()`` and
checks every step's contracts.  ``force_backend`` is the engine backend
the cell's contract names: the reference's ``"pallas"`` is the port's
``"cuda"``.  On a host device the steps run the plain versions whatever
is named (the engine refuses ``cuda`` for host tensors), and the card-only
rules are listed as not bound.

A mesh of more than one rank runs as ranks through ``launch.mesh.spawn``
(gloo on the CPU, one process a rank on the card), each rank auditing its
own steps; (1, 1) and no mesh run in the calling process.  A single-host
cell (``meshes=(None,)``: speculation has no sharded dispatch) runs with
no mesh whatever mesh is asked for.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

DEFAULT_MESHES = ((1, 1), (8, 1), (2, 4))
TP_GOLDEN = dict(name="tp-golden", n_layers=2, d_model=1024, n_heads=8,
                 n_kv_heads=8, head_dim=128, d_ff=2048, vocab=512,
                 dtype="float32", layer_pattern=("attn",),
                 ffn_pattern=("dense",))


@dataclass(frozen=True)
class AuditCell:
    """One batcher configuration in the audit matrix."""
    name: str
    config: str = "smollm-135m"      # configs registry name, or "tp-golden"
    precision: str | None = None     # override cfg.precision (None = keep)
    paged: bool = False
    kv_bits: int = 8                 # paged KV storage width
    speculative: bool = False
    force_backend: str | None = None  # the contract's engine backend
    n_slots: int = 8
    s_max: int = 24
    chunk_size: int = 4
    meshes: tuple = DEFAULT_MESHES


# the reference's matrix: smollm pure-DP, d1024 TP, 2xT quantized
# activations, dense and paged where each applies
CELLS = (
    AuditCell(name="smollm-dp"),
    AuditCell(name="smollm-dp-paged", paged=True, kv_bits=8),
    AuditCell(name="smollm-2xT", precision="2xT", force_backend="cuda"),
    AuditCell(name="smollm-2xT-paged", precision="2xT", paged=True,
              kv_bits=8, force_backend="cuda"),
    # float weights with the kernels: the fused decode (B4) runs, so
    # fused_decode_single_dispatch binds on paged:decode
    AuditCell(name="smollm-fp-paged-pallas", paged=True, kv_bits=8,
              force_backend="cuda"),
    AuditCell(name="smollm-spec", paged=True, kv_bits=8, speculative=True,
              meshes=(None,)),      # the windowed verify is single-host
    AuditCell(name="tp-d1024", config="tp-golden", n_slots=2, s_max=16),
)


def cell_by_name(name: str) -> AuditCell:
    for c in CELLS:
        if c.name == name:
            return c
    raise KeyError(f"unknown audit cell {name!r}; known: "
                   f"{[c.name for c in CELLS]}")


def build_model_and_params(cell: AuditCell, device="cpu"):
    """(model, cfg, serving params) of ``cell``, drawn from seed 0 on
    ``device``: the reduced config in float32 (two layers at a precision
    override), or the TP acceptance config ``tp-golden`` (d_model 1024, so
    the sharder tensor-parallelizes it), packed for a model axis of 8."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, reduce_for_smoke, to_serving
    from repro_torch.models.config import ModelConfig
    if cell.config == "tp-golden":
        cfg = ModelConfig(**TP_GOLDEN, precision=cell.precision or "2xT")
        tp = 8
    else:
        cfg = dataclasses.replace(reduce_for_smoke(get_config(cell.config)),
                                  dtype="float32")
        if cell.precision:
            cfg = dataclasses.replace(cfg, precision=cell.precision,
                                      n_layers=2)
        tp = 1
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = to_serving(model.init(gen, device), cfg, tp=tp)
    return model, cfg, params


def _serving_config(cell: AuditCell, mesh):
    from repro_torch.runtime.serving import ServingConfig
    kw = dict(n_slots=cell.n_slots, s_max=cell.s_max,
              chunk_size=cell.chunk_size, mesh=mesh)
    if cell.paged:
        kw.update(kv_bits=cell.kv_bits, block_size=4)
    if cell.speculative:
        kw.update(speculative=True, draft_k=2)
    return ServingConfig(**kw)


def prime_cell_tuning(cell: AuditCell, model_cfg, mesh) -> int:
    """Insert default tiles (no measuring) for every per-rank shape class
    the cell's steps look up (``engine.prime_serving_shapes``); with
    speculation, the draft's classes and the verify window's rows too.
    Returns the shape classes covered."""
    from repro_torch.core.precision import get_precision, signed
    from repro_torch.kernels import engine
    n = engine.prime_serving_shapes(
        model_cfg, signed(get_precision(model_cfg.precision)),
        n_slots=cell.n_slots, chunk_size=cell.chunk_size, mesh=mesh)
    if cell.speculative:
        draft_cfg = dataclasses.replace(model_cfg, precision="2xT")
        n += engine.prime_serving_shapes(
            draft_cfg, signed(get_precision("2xT")),
            n_slots=cell.n_slots, chunk_size=cell.chunk_size, mesh=mesh,
            extra_m=(cell.n_slots * 3,))
    return n


def build_cell_steps(cell: AuditCell, mesh, *, device="cpu",
                     prime: bool = True, _cache: dict | None = None) -> list:
    """Construct the cell's batcher on ``mesh`` (a mesh of ranks, or None)
    and enumerate its step functions (StepSpecs) under the cell's
    ``force_backend``.  ``_cache`` memoizes model and params across meshes
    of the same cell."""
    if _cache is not None and cell.name in _cache:
        model, cfg, params = _cache[cell.name]
    else:
        model, cfg, params = build_model_and_params(cell, device)
        if _cache is not None:
            _cache[cell.name] = (model, cfg, params)
    if prime:
        prime_cell_tuning(cell, cfg, mesh)
    from repro_torch.runtime.kvcache import PagedBatcher
    from repro_torch.runtime.serving import ContinuousBatcher
    cls = PagedBatcher if cell.paged else ContinuousBatcher
    b = cls(model, params, _serving_config(cell, mesh))
    return b.audit_steps(cell.force_backend)


def _audit_steps(mesh, cell: AuditCell, label, device, _cache=None):
    """(findings, checked) of ``cell``'s steps on this process's ``mesh``
    (a rank's, or None)."""
    from .rules import audit_step
    findings, checked = [], []
    for spec in build_cell_steps(cell, mesh, device=device, _cache=_cache):
        got, rules = audit_step(spec)
        checked.append({"cell": cell.name, "mesh": label,
                        "rank": None if mesh is None else mesh.rank,
                        "step": spec.name, **rules})
        findings.extend(got)
    return findings, checked


def audit_cell(cell: AuditCell, mesh_shape, *, device="cpu",
               _cache: dict | None = None):
    """Audit one (cell, mesh): build, prime, enumerate, check.  Returns
    ``(findings, checked)``; ``checked`` records every (step, rank, bound
    rules, rules not bound off the card).  A mesh of several ranks is
    spawned, one process a rank, and the ranks' results are joined."""
    from repro_torch.launch.mesh import Mesh, make_mesh, spawn
    if cell.meshes == (None,):
        mesh_shape = None
    label = list(mesh_shape) if mesh_shape else None
    if mesh_shape is None:
        return _audit_steps(None, cell, label, device, _cache)
    dp, mp = mesh_shape
    if dp * mp == 1:
        return _audit_steps(make_mesh(1, 1), cell, label, device, _cache)
    findings, checked = [], []
    for f, c in spawn(_audit_steps, Mesh({"data": dp, "model": mp}), cell,
                      label, device, device=str(device)):
        findings.extend(f)
        checked.extend(c)
    return findings, checked
