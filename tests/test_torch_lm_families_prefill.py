"""Port parity for the last decoder-only LM families
(``tests/torch_lm_families_common.py``): the registry and the post-norm
keys, the embedding scale, the gelu fault C3 (the port's ``_act(x,
"gelu")`` against ``jax.nn.gelu``), and a whole-prompt prefill then one
decode step against the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import reduce_for_smoke  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from torch_lm_families_common import (  # noqa: E402,F401
    GRID, GRID_IDS, S_MAX, _batch, _close, _inputs, _pair, _t, _tuning_cache)


def test_gelu_matches_jax():
    """Fault C3: ``jax.nn.gelu`` defaults to the tanh approximation; the
    erf form (``F.gelu(x)``) parts from it by up to 4.7e-4 on [-6, 6]."""
    x = np.linspace(-6.0, 6.0, 20001, dtype=np.float32)
    got = L._act(torch.from_numpy(x), "gelu").numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    assert np.abs(got - want).max() <= 1e-6


def test_registry_and_post_norm_keys():
    """All ten reference arch ids build; the post-norms and the embedding
    scale follow the config's fields, never its name."""
    from repro.configs import ARCH_IDS as JARCH_IDS
    assert ARCH_IDS == JARCH_IDS
    for arch in ARCH_IDS:
        cfg = reduce_for_smoke(get_config(arch))
        build_model(cfg)
        assert cfg.post_norms == cfg.embed_scale == (arch == "gemma2-27b")
    cfg = reduce_for_smoke(get_config("glm4-9b"))
    p = build_model(dataclasses.replace(cfg, post_norms=True)).init(
        torch.Generator().manual_seed(0), "cpu")
    assert "post_norm" in p["blocks"]["layer_0"]["attn"]
    assert "post_norm" in p["blocks"]["layer_0"]["ffn"]
    renamed = dataclasses.replace(reduce_for_smoke(get_config("gemma2-27b")),
                                  name="renamed", post_norms=False)
    p = build_model(renamed).init(torch.Generator().manual_seed(0), "cpu")
    assert "post_norm" not in p["blocks"]["layer_0"]["attn"]


def test_embed_scale_rounds_to_the_model_dtype():
    """sqrt(4608) = 67.88 is rounded to the model dtype before the multiply,
    as the reference does: 68.0 in bf16."""
    cfg = dataclasses.replace(get_config("gemma2-27b"), dtype="bfloat16")
    params = {"embed": {"w": torch.ones((4, 3), dtype=torch.bfloat16)}}
    x = tfm._embed(params, torch.tensor([[1, 2]]), cfg)
    assert x.dtype == torch.bfloat16 and bool((x == 68.0).all())
    params = {"embed": {"w": torch.ones((4, 3), dtype=torch.float32)}}
    x = tfm._embed(params, torch.tensor([[1]]),
                   dataclasses.replace(cfg, dtype="float32"))
    assert abs(float(x[0, 0, 0]) - 4608 ** 0.5) < 1e-5


# ---------------------------------------------------------------------------
# model entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,precision,kv_bits", GRID, ids=GRID_IDS)
def test_prefill_and_decode_logits(arch, precision, kv_bits):
    """A whole prompt (B=3, 12 positions: past gemma2-w8's window), then
    one decode step at ragged per-slot positions.  The prefill's KV codes
    are held within one step of the reference's; the decode step is held
    on the same inputs, the reference's cache (a K/V value on a rounding
    boundary rounds either way under f32 summation order, and one such
    code moves the next step's logits by ~1e-4)."""
    jm, jsv, tm, tp = _pair(arch, precision, kv_bits)
    x = _inputs(tm.cfg, 3, 12, seed=2)
    lj, cj = jm.prefill(jsv, _batch(tm.cfg, jnp.asarray(x)), S_MAX)
    lt, ct = tm.prefill(tp, _batch(tm.cfg, _t(x)), S_MAX)
    _close(lt, lj)
    for name, leaf in ct.items():
        for k, v in leaf.items():
            if v.dtype == torch.int8:
                diff = np.abs(v.numpy().astype(np.int16)
                              - np.asarray(cj[name][k]).astype(np.int16))
                assert diff.max() <= 1, f"{name}/{k}"
    pos = np.array([12, 9, 4], np.int32)
    step = _inputs(tm.cfg, 3, 1, seed=9)
    lj, _ = jm.decode_step(jsv, jnp.asarray(step), cj, jnp.asarray(pos))
    ct = params_from_numpy(jax.tree_util.tree_map(np.array, cj), "cpu")
    lt, _ = tm.decode_step(tp, _t(step), ct, torch.from_numpy(pos))
    _close(lt, lj)
