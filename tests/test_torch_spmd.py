"""Serving over a mesh of ranks (``ServingConfig.mesh``) against the
reference's no-mesh streams, on 4 CPU ranks over gloo.

One spawn of 4 ranks (a module fixture: process start-up is the cost)
runs every multi-rank check of tests/torch_spmd_ranks.py; the reference's
side runs here, and its expert-parallel MoE in a subprocess on 4 virtual
CPU devices (as tests/test_moe_shard_map.py runs it).

Contract (the reference's tests/test_serving_spmd.py): greedy streams of
the sharded dense and paged batchers are identical to the one-rank run's
and to the reference's no-mesh batcher's — the reduced smollm (pure DP) at
2xT on meshes 1,1 / 2,1 / 1,2 / 2,2, the ``tp-golden`` model (d 1024,
tensor parallel) at 2xT on 2,1 / 1,2 / 2,2, a GQA model whose query heads
split and KV heads do not (1,4).  Bounds: fp32 and 1x1 under tensor
parallelism within 1e-4 of max|logit| (partial sums in another order; at
1x1 the row scale mean|x| is a K-sharded float sum); the expert-parallel
MoE within 1e-5 of max|out| of the reference's ``moe_apply_shard_map``.

Mamba and hybrid stacks on a model axis (d_inner cut over it): falcon-mamba
(reduced, d_model 1024) at 2xT on 2,1 / 1,2 / 2,2 and jamba (one period at
d_model 1024) at 2xT on 1,2 give the reference's one-device streams (the
integer partial sums are exact and the scan is per channel); at fp32 a
whole-prompt prefill's and a decode step's logits on 1,2 within 1e-4 of
max|logit| of the one-rank calls, and the streams the reference's.  jamba
is held on a pure model axis only: its MoE capacity depends on the
call's rows (ROADMAP Queue C).

Sequence-parallel decode (B = 1, the cache cut over its sequence by
``cache_specs``, each rank attending its positions and the partials
combined by their log-sum-exp): the reduced smollm at fp32 (float cache)
and 2xT kv8 on 4,1, a glm4 at d_model 1024 whose 2 KV heads do not divide
4 under ``kv_seq_shard`` on 1,4 (the cache cut over the model axis that
also cuts the query heads), gemma2 with a window of 12 over 4 slices of 8
positions (the window straddles ranks; softcap and the float cache), and
jamba on 2,2 (pure DP; the Mamba states replicated), from the port's
draw: greedy streams equal the reference's one-device streams on the same
params; fp32 logits within 1e-4 of max|logit|.  The dry run of glm4's 1,4 step on each rank of a dry 1,4 mesh
(``launch.dryrun.decode_cell``, the host's routes) equals the real step's
collective counts and wire bytes, dispatches and argument bytes."""
import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import (  # noqa: E402,F401
    one_thread, ranks_one_thread, reference_jit)
import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.runtime.kvcache import PagedBatcher as JPagedBatcher  # noqa: E402
from repro.runtime.serving import ContinuousBatcher as JBatcher  # noqa: E402
from repro.runtime.serving import Request as JRequest  # noqa: E402
from repro.runtime.serving import RequestOptions as JOptions  # noqa: E402
from repro.runtime.serving import ServingConfig as JServingConfig  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model, reduce_for_smoke, to_serving  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.runtime.adaptive import AdaptiveServer  # noqa: E402
from repro_torch.runtime.kvcache import PagedBatcher  # noqa: E402
from repro_torch.runtime.serving import ServingConfig  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_spmd_ranks as ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TP_GOLDEN = dict(name="tp-golden", n_layers=2, d_model=1024, n_heads=8,
                 n_kv_heads=8, head_dim=128, d_ff=2048, vocab=512,
                 dtype="float32", layer_pattern=("attn",),
                 ffn_pattern=("dense",), precision="2xT")
MIXED = dict(TP_GOLDEN, name="gqa-split", n_kv_heads=2)
MOE_GOLDEN = dict(TP_GOLDEN, name="moe-golden", n_kv_heads=2, n_experts=4,
                  top_k=2, moe_d_ff=64, ffn_pattern=("moe",))
# Mamba stacks on a model axis: (payload, arch, precision, cut of the
# reduced config, seed).  d_model 1024 makes them tensor parallel (the
# reduced 128 is pure DP); jamba keeps one period of its 8 layers (seven
# Mamba layers, one attention, four dense FFNs and four MoE)
MAMBA_TP = (("mamba_tp", "falcon-mamba-7b", "2xT", {"d_model": 1024}, 6),
            ("jamba_tp", "jamba-v0.1-52b", "2xT",
             {"d_model": 1024, "n_layers": 8}, 7),
            ("mamba_fp32", "falcon-mamba-7b", "fp32", {"d_model": 1024}, 8))

MOE_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_config
from repro.models import reduce_for_smoke
from repro.parallel.moe_shard_map import moe_apply_shard_map

inp = np.load(sys.argv[1])
cfg = dataclasses.replace(
    reduce_for_smoke(get_config("granite-moe-1b-a400m", precision="fp32")),
    n_experts=8, top_k=2, dtype="float32")
mesh = jax.make_mesh((2, 2), ("data", "model"))
p = {"norm": {"g": jnp.asarray(inp["g"])},
     "w_router": jnp.asarray(inp["w_router"]),
     "w_gate": jnp.asarray(inp["w_gate"]), "w_up": jnp.asarray(inp["w_up"]),
     "w_down": jnp.asarray(inp["w_down"])}
x = jnp.asarray(inp["x"])
out = {}
for cap in (64.0, 1.0):
    c = dataclasses.replace(cfg, capacity_factor=cap)
    with mesh:
        got, aux = jax.jit(lambda p_, x_: moe_apply_shard_map(p_, x_, c, mesh))(p, x)
    out[f"out_{cap}"] = np.asarray(got)
    out[f"aux_{cap}"] = np.asarray(aux)
np.savez(sys.argv[2], **out)
print("REF_MOE_OK")
"""


# sequence-parallel decode: name -> (arch, precision, kv_bits, cut of the
# reduced config, mesh, kv_seq_shard, tp of the serving form, seed)
SP_JOBS = {
    "smollm fp32": ("smollm-135m", "fp32", 0, {}, "4,1", False, 1, 20),
    "smollm 2xT": ("smollm-135m", "2xT", 8, {}, "4,1", False, 1, 21),
    "glm4 kv_seq_shard": ("glm4-9b", "2xT", 8,
                          {"d_model": 1024, "n_heads": 8}, "1,4", True, 4,
                          22),
    "gemma2 window": ("gemma2-27b", "fp32", 0, {"window": 12}, "4,1", False,
                      1, 23),
    "jamba": ("jamba-v0.1-52b", "2xT", 8, {}, "2,2", False, 1, 24),
}
SP_S_MAX, SP_NEW = 32, 6


def _sp_payload():
    """(the reference's configs and params, the ranks' jobs) of SP_JOBS:
    the port's draw from the job's seed, in serving form at 2xT (packed
    with the job's tp), given to the reference through ``interop``."""
    jobs, ref = {}, {}
    for name, (arch, prec, kvb, cut, mesh, kvss, tp, seed) in \
            SP_JOBS.items():
        jcfg = dataclasses.replace(
            jreduce(jget_config(arch, precision=prec, kv_bits=kvb)), **cut)
        tcfg = dataclasses.replace(
            reduce_for_smoke(get_config(arch, precision=prec, kv_bits=kvb)),
            **cut)
        params = _port_params(tcfg, seed, tp)
        prompt = np.random.default_rng(seed).integers(0, tcfg.vocab, (1, 9))
        # copies: the spawn moves the tensors' storage into shared memory
        ref[name] = (jcfg, jax.tree_util.tree_map(
            np.array, params_to_numpy(params)), prompt)
        jobs[name] = {"cfg": tcfg, "params": params, "prompt": prompt,
                      "s_max": SP_S_MAX, "n_new": SP_NEW,
                      "kv_seq_shard": kvss, "mesh": mesh, "tp": tp,
                      "dry": name == "glm4 kv_seq_shard"}
    return ref, jobs


def _ref_sp_stream(jcfg, params, prompt):
    """The reference's one-device greedy stream of ``prompt`` on
    ``params`` (numpy leaves): its prefill into a cache of SP_S_MAX, then
    SP_NEW decode steps (their logits)."""
    import jax.numpy as jnp
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    model = jbuild(jcfg)
    logits, cache = reference_jit(lambda p, b: model.prefill(p, b, SP_S_MAX))(
        jp, {"tokens": jnp.asarray(prompt, jnp.int32)})
    step = reference_jit(model.decode_step)
    tok = jnp.argmax(logits[:, -1], -1)
    stream, steps = [int(tok[0])], []
    for i in range(SP_NEW):
        out, cache = step(jp, tok[:, None].astype(jnp.int32), cache,
                          jnp.int32(prompt.shape[1] + i))
        steps.append(np.asarray(out[:, -1]))
        tok = jnp.argmax(out[:, -1], -1)
        stream.append(int(tok[0]))
    return stream, np.concatenate(steps)


def _prompts(vocab, n):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, (1, 5 + i)) for i in range(n)]


def _ref_streams(jcfg, params, kind, n_reqs, n_slots, s_max, chunk=4):
    """The reference's no-mesh batcher on tests/torch_spmd_ranks.serve's
    requests."""
    if kind == "paged":
        jcfg = dataclasses.replace(jcfg, kv_bits=0)
        b = JPagedBatcher(jbuild(jcfg), params, JServingConfig(
            n_slots=n_slots, s_max=s_max, chunk_size=chunk, kv_bits=8,
            block_size=4))
    else:
        b = JBatcher(jbuild(jcfg), params, JServingConfig(
            n_slots=n_slots, s_max=s_max, chunk_size=chunk))
    for i, t in enumerate(_prompts(jcfg.vocab, n_reqs)):
        b.submit(JRequest(rid=i, tokens=t.astype(np.int32),
                          options=JOptions(max_new=4)))
    return {r.rid: [int(v) for v in r.output] for r in b.run()}


def _port_params(cfg, seed, tp):
    model = build_model(cfg)
    return to_serving(model.init(torch.Generator().manual_seed(seed), "cpu"),
                      cfg, tp=tp)


def _moe_inputs(d, e, f):
    rng = np.random.default_rng(7)
    n = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return {"g": 1.0 + 0.1 * n(d), "w_router": n(d, e) * d ** -0.5,
            "w_gate": n(e, d, f) * d ** -0.5, "w_up": n(e, d, f) * d ** -0.5,
            "w_down": n(e, f, d) * f ** -0.5, "x": n(4, 8, d)}


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd")
    saved = os.environ.get("REPRO_TUNING_CACHE")
    os.environ["REPRO_TUNING_CACHE"] = str(tmp / "tuning.json")
    try:
        yield _run_spmd(tmp)
    finally:
        if saved is None:
            os.environ.pop("REPRO_TUNING_CACHE", None)
        else:
            os.environ["REPRO_TUNING_CACHE"] = saved


def _run_spmd(tmp):
    # the reference's expert-parallel MoE, alongside everything else
    moe_cfg = dataclasses.replace(
        reduce_for_smoke(get_config("granite-moe-1b-a400m",
                                    precision="fp32")),
        n_experts=8, top_k=2, dtype="float32")
    moe_in = _moe_inputs(moe_cfg.d_model, 8, moe_cfg.moe_d_ff)
    np.savez(tmp / "moe_in.npz", **moe_in)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", MOE_SCRIPT, str(tmp / "moe_in.npz"),
         str(tmp / "moe_out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    payload = {}
    jcfg = jreduce(jget_config("smollm-135m", precision="2xT"))
    tcfg = reduce_for_smoke(get_config("smollm-135m", precision="2xT"))
    jp = reference_jit(
        lambda k: jto_serving(jbuild(jcfg).init(k), jcfg, tp=1))(
        jax.random.PRNGKey(0))
    payload["smollm"] = {"cfg": tcfg, "params": params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")}
    jtp = JModelConfig(**TP_GOLDEN)
    jpt = reference_jit(lambda k: jto_serving(jbuild(jtp).init(k), jtp, tp=2))(
        jax.random.PRNGKey(1))
    payload["tp_golden"] = {"cfg": ModelConfig(**TP_GOLDEN),
                            "params": params_from_numpy(
                                jax.tree_util.tree_map(np.asarray, jpt),
                                "cpu")}
    f32 = ModelConfig(**dict(TP_GOLDEN, precision="fp32"))
    payload["tp_fp32"] = {"cfg": f32, "params": _port_params(f32, 2, 1),
                          "tokens": np.array([[3, 141, 59, 265]], np.int64)}
    b1 = ModelConfig(**dict(TP_GOLDEN, precision="1x1"))
    payload["tp_1x1"] = {"cfg": b1, "params": _port_params(b1, 3, 2)}
    mixed = ModelConfig(**MIXED)
    payload["mixed"] = {"cfg": mixed, "params": _port_params(mixed, 4, 4)}
    payload["moe"] = {"cfg": moe_cfg, "x": torch.from_numpy(moe_in["x"]),
                      "p": {"norm": {"g": torch.from_numpy(moe_in["g"])},
                            **{k: torch.from_numpy(moe_in[k])
                               for k in ("w_router", "w_gate", "w_up",
                                         "w_down")}}}
    mg = ModelConfig(**MOE_GOLDEN)
    payload["moe_golden"] = {"cfg": mg, "params": _port_params(mg, 5, 2)}
    mamba = reduce_for_smoke(get_config("falcon-mamba-7b", precision="2xT"))
    payload["mamba"] = {"cfg": mamba, "params": _port_params(mamba, 6, 1)}
    # Mamba stacks on a model axis, drawn by the reference: the mamba_tp
    # and jamba_tp streams are held to its one-device batcher's
    jmamba = {}
    for name, arch, precision, cut, seed in MAMBA_TP:
        jcfg_m = dataclasses.replace(
            jreduce(jget_config(arch, precision=precision)), **cut)
        jmp = reference_jit(lambda k, c=jcfg_m: jto_serving(
            jbuild(c).init(k), c, tp=2))(jax.random.PRNGKey(seed))
        jmamba[name] = (jcfg_m, jmp)
        payload[name] = {"cfg": dataclasses.replace(
            reduce_for_smoke(get_config(arch, precision=precision)), **cut),
            "params": params_from_numpy(
                jax.tree_util.tree_map(np.asarray, jmp), "cpu")}
    payload["mamba_ckpt"] = str(tmp / "mamba_ckpt")
    sp_ref, payload["sp"] = _sp_payload()

    # the ranks run while this process serves the one-device side
    with ranks_one_thread(), concurrent.futures.ThreadPoolExecutor(1) as pool:
        fut = pool.submit(tmesh.spawn, ranks.run_checks,
                          tmesh.Mesh({"data": 2, "model": 2}), payload,
                          device="cpu")
        ref = {}
        for kind in ("dense", "paged"):
            ref[f"smollm_{kind}"] = _ref_streams(jcfg, jp, kind, 3, 4, 24)
            ref[f"tp_{kind}"] = _ref_streams(jtp, jpt, kind, 2, 2, 16)
        # the port on one device, for the configs the reference does not
        # serve
        one = {name: ranks.serve(payload[name]["cfg"],
                                 payload[name]["params"], None, "dense", 2,
                                 2, s_max=16)[0]
               for name in ("mixed", "moe_golden", "tp_fp32", "tp_1x1")}
        one["mixed_paged"] = ranks.serve(mixed, payload["mixed"]["params"],
                                         None, "paged", 2, 2, s_max=16)[0]
        one["mamba"] = ranks.serve(mamba, payload["mamba"]["params"], None,
                                   "dense", 2, 4, chunk=0)[0]
        for name, (jcfg_m, jmp) in jmamba.items():
            ref[name] = _ref_streams(jcfg_m, jmp, "dense", 2, 4, 24, chunk=0)
        for name, args in sp_ref.items():
            ref[f"sp {name}"] = _ref_sp_stream(*args)
        results = fut.result()
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr[-3000:]
    moe_ref = dict(np.load(tmp / "moe_out.npz"))
    return {"ref": ref, "one": one, "ranks": results, "moe_ref": moe_ref,
            "cfg": {name: payload[name]["cfg"] for name, *_ in MAMBA_TP}}


def test_collectives(spmd):
    """all_reduce_sum / all_reduce_max over both axes, all_gather along a
    dim, broadcast from index 1 of the model axis, each counted once; a
    bfloat16 max round-trips through gloo's float32."""
    for res in spmd["ranks"]:
        r, d = res["rank"], res["rank"] // 2
        total, top, rows, bcast, cols, counts = res["collectives"]
        assert total == [6.0, -6.0] and top == [3.0, 0.0]
        assert rows == [[float(i), -float(i)] for i in range(4)]
        assert bcast == [2.0 * d + 1, -(2.0 * d + 1)]
        j = r % 2
        assert cols == [[float(j), -float(j), float(j + 2), -float(j + 2)]]
        assert counts == {"all_reduce_sum": 1, "all_reduce_max": 1,
                          "all_gather": 2, "broadcast": 1}


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_pure_dp_streams_every_mesh(spmd, kind):
    """Reduced smollm 2xT f32 (pure DP): one-rank, 2,1, 1,2 and 2,2
    streams equal the reference's no-mesh streams on every rank; a pure-DP
    step reduces nothing (the dense decode gathers its next tokens, the
    paged step runs whole on every rank)."""
    want = spmd["ref"][f"smollm_{kind}"]
    for res in spmd["ranks"]:
        for label in ("1,1", "pair", "2,2"):
            streams, counts, calls = res[f"smollm_{kind}_{label}"]
            assert streams == want, (res["rank"], label)
            assert counts["all_reduce_sum"] == counts["all_reduce_max"] == 0
            if kind == "paged" or label == "1,1":
                assert counts["all_gather"] == 0
            else:
                assert counts["all_gather"] == calls["decode"] > 0
    assert [r["pair"] for r in spmd["ranks"]] == \
        [{"data": 2, "model": 1}] * 2 + [{"data": 1, "model": 2}] * 2


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_tensor_parallel_streams(spmd, kind):
    """tp-golden 2xT (packed with to_serving(tp=2)) on 2,1, 1,2 and 2,2:
    streams equal the reference's no-mesh streams.  Per model call and
    layer, a max and a sum around wo and w_down; one sum for the embedding
    and one gather for the logits a call; on 2,2 the dense decode also
    gathers its next tokens over data."""
    want = spmd["ref"][f"tp_{kind}"]
    n_layers = TP_GOLDEN["n_layers"]
    for res in spmd["ranks"]:
        for label in ("pair", "2,2"):
            streams, counts, calls = res[f"tp_{kind}_{label}"]
            assert streams == want, (res["rank"], label, kind)
            model_split = label == "2,2" or res["pair"]["model"] == 2
            n = calls["decode"] + calls["chunks"]
            if not model_split:
                assert counts["all_reduce_max"] == 0
                continue
            assert counts["all_reduce_max"] == 2 * n_layers * n
            assert counts["all_reduce_sum"] == (2 * n_layers + 1) * n
            gathers = n + (calls["decode"] if label == "2,2"
                           and kind == "dense" else 0)
            assert counts["all_gather"] == gathers


def test_gqa_heads_split_kv_whole(spmd):
    """8 query heads over a model axis of 4, 2 KV heads kept whole: each
    rank attends with its groups' KV heads; streams equal one rank's,
    dense and paged."""
    for res in spmd["ranks"]:
        assert res["mixed_1,4"][0] == spmd["one"]["mixed"]
        assert res["mixed_1,4_paged"][0] == spmd["one"]["mixed_paged"]


def test_float_and_1x1_tensor_parallel_within_bound(spmd):
    """fp32 and 1x1 tp-golden on 1,2: a prefill chunk's and a decode
    step's logits within 1e-4 of max|logit| of the one-rank calls; streams
    reported beside the one-rank run's (not claimed equal)."""
    for res in spmd["ranks"][2:]:
        for name in ("tp_fp32", "tp_1x1"):
            gap, scale = res[f"{name}_gap"]
            assert gap <= 1e-4 * scale, (name, gap, scale)
            got, one = res[f"{name}_streams"], spmd["one"][name]
            print(f"rank {res['rank']} {name}: logits gap {gap:.3e} of "
                  f"{scale:.3e}; streams equal to one rank's: {got == one}")
            assert sorted(got) == sorted(one)


def test_moe_shard_map_matches_reference(spmd):
    """moe_apply_shard_map on a 2,2 mesh (each rank its data shard of the
    tokens and its 4 of 8 experts) against the reference's on 4 virtual
    devices: within 1e-5 of max|out|, capacity 64 (no drops) and 1 (per
    data-shard drops); aux within 1e-6.  The slot-map moe_apply under TP
    (global slot map) within 1e-5 of the one-device call."""
    ref = spmd["moe_ref"]
    for res in spmd["ranks"]:
        d = res["rank"] // 2                      # data coordinate
        for cap in (64.0, 1.0):
            got, aux = res["moe"][f"shard_map_{cap}"]
            want = ref[f"out_{cap}"][2 * d:2 * d + 2]
            scale = float(np.abs(want).max())
            assert float(np.abs(got - want).max()) <= 1e-5 * scale, cap
            assert abs(aux - float(ref[f"aux_{cap}"])) <= 1e-6 * abs(aux)
        gap, scale = res["moe"]["pjit_gap"]
        assert gap <= 1e-5 * scale


def test_moe_and_mamba_through_the_batcher(spmd):
    """An MoE model (d 1024, 4 experts top-2) through the dense batcher:
    on 1,2 both MoE paths give one rank's streams (two experts a token
    sum the same two terms); on 2,1 the slot map's (global) too.  The
    reduced falcon-mamba on pure-DP meshes gives one rank's streams, and
    at d_model 1024 on a model axis > 1 (2,2) the reference's one-device
    streams."""
    for res in spmd["ranks"]:
        assert res["moe_golden_pjit"] == spmd["one"]["moe_golden"]
        if res["pair"]["model"] == 2:
            assert res["moe_golden_shard_map"] == spmd["one"]["moe_golden"]
        assert res["mamba_pair"] == spmd["one"]["mamba"]
        assert res["mamba_tp_2,2"][0] == spmd["ref"]["mamba_tp"]


def _mamba_runs(spmd):
    """(name, label, rank result, (streams, counts, calls), cache shapes)
    of every Mamba-stack run on a mesh."""
    for res in spmd["ranks"]:
        pair = "1,2" if res["pair"]["model"] == 2 else "2,1"
        yield ("mamba_tp", pair, res, res["mamba_tp_pair"],
               res["mamba_tp_cache_pair"])
        yield ("mamba_tp", "2,2", res, res["mamba_tp_2,2"],
               res["mamba_tp_cache_2,2"])
        if "jamba_tp" in res:
            yield "jamba_tp", "1,2", res, res["jamba_tp"], \
                res["jamba_tp_cache"]


@pytest.mark.parametrize("job", ["mamba_tp 2,1", "mamba_tp 1,2",
                                 "mamba_tp 2,2", "jamba_tp 1,2"])
def test_mamba_tensor_parallel_streams(spmd, job):
    """falcon-mamba and jamba at 2xT over a mesh: greedy streams equal the
    reference's one-device streams on every rank.  On a model axis of 2,
    per model call and Mamba layer one gather of the xz rows, and a max
    and a sum around w_x and around w_out; per call a sum for the
    embedding and a gather for the logits; jamba's attention layer and
    dense FFNs a max and a sum each, its MoE layers a sum (no model axis:
    2,1 is pure DP, nothing is reduced)."""
    name, label = job.split()
    cfg = get_config("jamba-v0.1-52b" if name == "jamba_tp"
                     else "falcon-mamba-7b")
    n_layers = 8 if name == "jamba_tp" else 2
    pattern = (cfg.layer_pattern * n_layers)[:n_layers]
    ffns = (cfg.ffn_pattern * n_layers)[:n_layers]
    n_mamba = pattern.count("mamba")
    n_split = (n_layers - n_mamba) + ffns.count("dense")
    seen = 0
    for got_name, got_label, res, (streams, counts, calls), _ in \
            _mamba_runs(spmd):
        if (got_name, got_label) != (name, label):
            continue
        seen += 1
        assert streams == spmd["ref"][name], (res["rank"], job)
        n = calls["decode"] + calls["prefills"]
        assert calls["chunks"] == 0 and calls["prefills"] == 2
        if label == "2,1":
            assert counts["all_reduce_sum"] == counts["all_reduce_max"] == 0
            continue
        assert counts["all_reduce_max"] == (2 * n_mamba + n_split) * n
        assert counts["all_reduce_sum"] == \
            (2 * n_mamba + n_split + ffns.count("moe") + 1) * n
        gathers = (n_mamba + 1) * n + (calls["decode"] if label == "2,2"
                                       else 0)
        assert counts["all_gather"] == gathers, (job, counts, calls)
    assert seen == (2 if label != "2,2" else 4)


def test_mamba_cache_shapes_follow_cache_specs(spmd):
    """The batcher's slot cache over a mesh (4 slots) holds this rank's
    slices under ``cache_specs``: the conv (P, B / data, K-1, Di / model)
    and ssm (P, B / data, Di / model, N) states; jamba's attention KV
    (P, B, S, KV / model, Dh)."""
    for name, label, res, _, shapes in _mamba_runs(spmd):
        cfg = spmd["cfg"][name]
        dp, mp = (int(v) for v in label.split(","))
        di, n_per = cfg.d_inner, cfg.n_periods
        for i, mixer in enumerate(cfg.layer_pattern):
            key = f"layer_{i}"
            if mixer == "mamba":
                assert shapes[(key, "conv")] == \
                    (n_per, 4 // dp, cfg.ssm_conv - 1, di // mp), (name, label)
                assert shapes[(key, "ssm")] == \
                    (n_per, 4 // dp, di // mp, cfg.ssm_state)
            else:
                assert shapes[(key, "k")] == \
                    (n_per, 4 // dp, 24, cfg.n_kv_heads // mp, cfg.head_dim)


def test_mamba_fp32_tensor_parallel_within_bound(spmd):
    """falcon-mamba fp32 on 1,2: a whole-prompt prefill's and a decode
    step's logits within 1e-4 of max|logit| of the one-rank calls (the
    partial products of w_x and w_out summed in another order); the
    streams equal the reference's one-device streams."""
    for res in spmd["ranks"][:2]:
        gap, scale = res["mamba_fp32_gap"]
        print(f"rank {res['rank']} mamba fp32 on 1,2: logits gap {gap:.3e} "
              f"of {scale:.3e}")
        assert gap <= 1e-4 * scale, (gap, scale)
        assert res["mamba_fp32_streams"] == spmd["ref"]["mamba_fp32"]


def test_mamba_checkpoint_of_a_model_axis_restores_on_one_rank(spmd):
    """A checkpoint of falcon-mamba's 2xT serving params written from 1,2
    (each rank its slices: w_in cut contiguously over its 2 Di columns, as
    ``param_specs`` cuts it) restores on a 1,1 mesh ``torch.equal`` to the
    whole params."""
    assert spmd["ranks"][0]["mamba_tp_restore"] is True
    assert spmd["ranks"][1]["mamba_tp_restore"] is None


@pytest.mark.parametrize("name", list(SP_JOBS))
def test_sequence_parallel_decode_streams(spmd, name):
    """B = 1 with the cache's sequence cut over the mesh (module
    docstring): every rank's greedy stream equals the reference's
    one-device stream; at fp32 the decode steps' logits within 1e-4 of
    max|logit| of the reference's.  Per decode step and attention layer,
    one all-reduce max of the log-sum-exp and one all-reduce sum of the
    weighted partials and their weights (packed); under ``kv_seq_shard``
    also one gather of the query heads, beside tensor parallelism's max and
    sum around wo and w_down, the embedding's sum and the logits' gather."""
    want, want_logits = spmd["ref"][f"sp {name}"]
    arch, prec, _, cut, mesh, kvss, _, _ = SP_JOBS[name]
    cfg = dataclasses.replace(reduce_for_smoke(get_config(arch)), **cut)
    n_attn = sum(m.startswith("attn") for m in cfg.layer_pattern) * \
        cfg.n_periods
    for res in spmd["ranks"]:
        got = res[f"sp_{name}"]
        assert got["stream"] == want, (res["rank"], name)
        if prec == "fp32":
            scale = float(np.abs(want_logits).max())
            gap = float(np.abs(got["logits"] - want_logits).max())
            print(f"{name} rank {res['rank']}: logits gap {gap:.3e} of "
                  f"{scale:.3e}")
            assert gap <= 1e-4 * scale, (name, gap, scale)
        counts = got["probe"][0]
        if kvss:
            n = cfg.n_layers
            assert counts == {"all_reduce_sum": 3 * n + 1,
                              "all_reduce_max": 3 * n,
                              "all_gather": n + 1, "broadcast": 0}, counts
        else:                            # pure DP: only the combine
            assert counts == {"all_reduce_sum": n_attn,
                              "all_reduce_max": n_attn, "all_gather": 0,
                              "broadcast": 0}, (name, counts)


def test_dry_run_equals_the_real_step(spmd):
    """glm4's 1,4 sequence-parallel decode step, traced by the dry run on
    each rank of a dry 1,4 mesh: its collective counts and wire bytes, its
    dispatches (op and backend) and its argument bytes equal the real
    step's on that rank."""
    for res in spmd["ranks"]:
        got = res["sp_glm4 kv_seq_shard"]
        counts, nbytes, dispatch, arg_bytes = got["probe"]
        assert got["dry"] == (counts, nbytes, dispatch, arg_bytes), \
            (res["rank"], got["dry"], got["probe"])
        assert sum(nbytes.values()) > 0 and dispatch["decode_attention"]


def test_launcher_mesh_cpu(capfd, tmp_path, monkeypatch):
    """``--mesh 2,1 --device cpu``: the launcher spawns two gloo ranks and
    prints the reference's SPMD line, the backend and the collectives;
    its streams are the launcher's one-device streams."""
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "t.json"))
    cli = ["--reduced", "--device", "cpu", "--requests", "3", "--slots",
           "2", "--prompt-len", "10", "--gen", "4"]
    base = tserve.main(cli)
    with ranks_one_thread():
        got = tserve.main(cli + ["--mesh", "2,1"])
    out = capfd.readouterr().out
    assert "mesh: 2 ranks (data=2 model=1) over gloo on the CPU" in out
    assert "SPMD serving on mesh data=2 model=1: decode batch sharded " \
           "2-way, tensor-parallel 1-way (pure-DP (params replicated))" in out
    assert "collectives (rank 0): all_reduce_sum=0" in out
    assert {r.rid: r.output for r in got} == {r.rid: r.output for r in base}
    with pytest.raises(ValueError, match="needs 4096 ranks"):
        tserve.main(cli + ["--mesh", "64,64"])


def test_mesh_refusals():
    """Speculative decoding takes no mesh (the reference's ValueError), nor
    does the adaptive server; a mesh of several ranks built from a shape
    alone has no groups."""
    cfg = dataclasses.replace(
        reduce_for_smoke(get_config("smollm-135m", precision="fp32")),
        kv_bits=0)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="single-host"):
        PagedBatcher(build_model(cfg), params, ServingConfig(
            n_slots=2, s_max=16, chunk_size=4, kv_bits=8, speculative=True,
            mesh=tmesh.Mesh({"data": 1, "model": 1})))
    with pytest.raises(ValueError, match="one device"):
        AdaptiveServer(build_model(cfg), params, ServingConfig(
            n_slots=2, s_max=16, chunk_size=4,
            mesh=tmesh.Mesh({"data": 1, "model": 1})))
    with pytest.raises(ValueError, match="shape alone"):
        tmesh.Mesh({"data": 2, "model": 1}).axis("data")


def test_launcher_takes_mamba_on_a_model_axis():
    """``--mesh 1,2`` with a tensor-parallel Mamba stack (d_model 1024)
    passes the launcher's mesh check, as the reference's launcher serves
    it; ``--brownout`` on a mesh is still refused."""
    import argparse
    cfg = dataclasses.replace(reduce_for_smoke(get_config("falcon-mamba-7b")),
                              d_model=1024)
    mesh = tmesh.Mesh({"data": 1, "model": 2})
    args = argparse.Namespace(brownout=False, speculative=False, mesh="1,2")
    assert tserve._check_mesh(args, cfg, mesh) is None
    with pytest.raises(SystemExit, match="brownout"):
        tserve._check_mesh(argparse.Namespace(
            brownout=True, speculative=False, mesh="1,2"), cfg, mesh)
