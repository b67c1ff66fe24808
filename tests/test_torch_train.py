"""Port parity for the training loop: ``launch.steps.make_train_step``
against the reference's, the data pipeline, cross-package checkpoints,
``runtime.ElasticTrainer``'s resume and preemption, and the
``launch.train`` CLI — all on the CPU at reduce_for_smoke shapes.

Train step bounds (reduced smollm, fp32 in float32, adamw lr 1e-3, from
the same params through ``interop`` and the same batches): each step's
loss and grad norm within 1e-5 relative; every param leaf within
0.1 lr per step taken.  The packages sum in different orders (a few f32
ulps in the gradients); Adam's first steps move each entry by about
lr * g / (|g| + eps), which is near +-lr whatever the ulps, except for an
entry whose gradient is itself at the ulps' level, where the step's size
follows the ulps (measured: 0.036 lr after three steps).
"""
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread, reference_jit  # noqa: E402,F401
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro.checkpoint import Checkpointer as JCheckpointer  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke as jreduce  # noqa: E402
from repro.optim import make_optimizer as jmake_optimizer  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy, params_to_numpy  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import build_model, reduce_for_smoke  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402
from repro_torch.runtime import ElasticTrainer  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

LR = 1e-3
METRIC_RTOL = 1e-5
PARAM_ATOL_PER_STEP = 0.1 * LR


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def smollm():
    jcfg = jreduce(jget_config("smollm-135m", precision="fp32"))
    tcfg = reduce_for_smoke(get_config("smollm-135m", precision="fp32"))
    jm = jbuild(jcfg)
    jp = reference_jit(jm.init)(jax.random.PRNGKey(0))
    return jm, jp, build_model(tcfg)


def _batches(vocab, n, b=4, s=16):
    rng = np.random.default_rng(1)
    return [{k: rng.integers(0, vocab, (b, s)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


@pytest.mark.parametrize("n_steps,accum,bits", [
    (3, 1, 0),          # one and three steps
    (1, 2, 0),          # two microbatches, f32 accumulator
    (2, 1, 8)])         # int8 gradient channel
def test_train_step_matches_reference(smollm, n_steps, accum, bits):
    jm, jp, tm = smollm
    jo, to = jmake_optimizer("adamw", lr=LR), make_optimizer("adamw", lr=LR)
    jstep = reference_jit(jmake_train_step(jm, jo, grad_compress_bits=bits,
                                     accum_steps=accum))
    tstep = make_train_step(tm, to, grad_compress_bits=bits,
                            accum_steps=accum)
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jp), "cpu")
    js, ts = jo.init(jp), to.init(tp)
    before = [x.clone() for x in tree_leaves(tp)]
    for i, b in enumerate(_batches(tm.cfg.vocab, n_steps)):
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()})
        tp, ts, tmet = tstep(tp, ts, {k: torch.from_numpy(v).long()
                                      for k, v in b.items()})
        for k in ("loss", "grad_norm"):
            want, got = float(jmet[k]), float(tmet[k])
            assert abs(got - want) <= METRIC_RTOL * abs(want), (i, k, got,
                                                                want)
        tol = PARAM_ATOL_PER_STEP * (i + 1)
        for j, (a, w) in enumerate(zip(tree_leaves(params_to_numpy(tp)),
                                       jax.tree_util.tree_leaves(jp))):
            err = float(np.abs(a - np.asarray(w)).max())
            assert err <= tol, f"step {i} leaf {j}: {err} > {tol}"
    assert int(ts["count"]) == int(js["count"]) == n_steps
    # the step leaves its inputs as they were and moves every leaf
    assert all(not torch.equal(a, b) for a, b in
               zip(before, tree_leaves(tp)))


def test_train_step_accumulation_is_the_mean_of_microbatches(smollm):
    """Within the port: two microbatches of 2 give the loss mean and the
    gradient mean of the two halves, which one batch of 4 gives too (the
    loss is a mean over equal-size halves)."""
    _, jp, tm = smollm
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jp), "cpu")
    sgd = make_optimizer("adamw", lr=0.0, weight_decay=0.0)
    b = {k: torch.from_numpy(v).long()
         for k, v in _batches(tm.cfg.vocab, 1)[0].items()}
    _, _, whole = make_train_step(tm, sgd)(tp, sgd.init(tp), b)
    _, _, acc = make_train_step(tm, sgd, accum_steps=2)(tp, sgd.init(tp), b)
    assert abs(float(acc["loss"]) - float(whole["loss"])) <= 1e-6
    assert abs(float(acc["grad_norm"]) - float(whole["grad_norm"])) <= \
        1e-5 * float(whole["grad_norm"])


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shard,num_shards,seed", [(0, 1, 0), (1, 2, 5)])
def test_synthetic_lm_batches_equal_reference(shard, num_shards, seed):
    kw = dict(vocab=500, seq_len=24, global_batch=4, shard=shard,
              num_shards=num_shards, seed=seed)
    a, b = jdata.SyntheticLM(**kw), tdata.SyntheticLM(**kw)
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k])
    assert b.state_dict() == a.state_dict() == {"step": 3}
    b.load_state_dict({"step": 1})
    a2 = jdata.SyntheticLM(**kw)
    next(a2)
    assert np.array_equal(next(b)["tokens"], next(a2)["tokens"])


def test_memmap_corpus_matches_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    tokens = np.random.default_rng(3).integers(0, 1000, 1000)
    tdata.MemmapCorpus.write(path, tokens)
    assert np.array_equal(np.fromfile(path, np.int32), tokens)
    for shard in (0, 1):
        a = jdata.MemmapCorpus(path, seq_len=32, global_batch=4, shard=shard,
                               num_shards=2)
        b = tdata.MemmapCorpus(path, seq_len=32, global_batch=4, shard=shard,
                               num_shards=2)
        for _ in range(20):          # past the corpus's 31 sequences: wraps
            x, y = next(a), next(b)
            assert y["tokens"].shape == (2, 32) and y["tokens"].dtype == np.int32
            assert np.array_equal(x["tokens"], y["tokens"])
            assert np.array_equal(y["labels"], y["tokens"])
        b.load_state_dict({"step": 4})
        assert b.state_dict() == {"step": 4}


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------
def _state_np():
    rng = np.random.default_rng(4)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "blocks": {"g": rng.standard_normal((2, 4)).astype(np.float32)}}


def _jax_state():
    p = jax.tree_util.tree_map(jnp.asarray, _state_np())
    p["b"] = p["b"].astype(jnp.bfloat16)
    opt = jmake_optimizer("adamw")
    return {"params": p, "opt": opt.init(p)}


def _torch_state():
    p = params_from_numpy(_state_np(), "cpu")
    p["b"] = p["b"].to(torch.bfloat16)
    return {"params": p, "opt": make_optimizer("adamw").init(p)}


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 \
            else x.numpy()
    return np.asarray(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def test_reference_checkpoint_restores_into_port(tmp_path):
    """The reference writes params with a bf16 leaf and an adamw state after
    one update; the port restores every leaf equal, bf16 as bf16."""
    js = _jax_state()
    opt = jmake_optimizer("adamw")
    g = jax.tree_util.tree_map(jnp.ones_like, js["params"])
    p, o, _ = opt.update(g, js["opt"], js["params"])
    js = {"params": p, "opt": o}
    JCheckpointer(str(tmp_path)).save(7, js)
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == 7
    got = ck.restore(7, _torch_state())
    assert got["params"]["b"].dtype == torch.bfloat16
    assert got["opt"]["count"].dtype == torch.int32 and \
        int(got["opt"]["count"]) == 1
    want = jax.tree_util.tree_leaves(js)
    leaves = tree_leaves(got)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        assert np.array_equal(_as_np(a), _as_np(b))


def test_port_checkpoint_restores_into_reference(tmp_path):
    """The port writes (bf16 leaf stored as its exact f32 values under
    dtype "bfloat16"); the reference's ``restore`` gives every leaf
    equal, bf16 as bf16."""
    ts = _torch_state()
    ts["opt"]["count"] = ts["opt"]["count"] + 3
    ts["opt"]["m"]["w"] = ts["opt"]["m"]["w"] + 0.5
    Checkpointer(str(tmp_path)).save(5, ts)
    got = JCheckpointer(str(tmp_path)).restore(5, _jax_state())
    assert got["params"]["b"].dtype == jnp.bfloat16
    for a, b in zip(jax.tree_util.tree_leaves(got), tree_leaves(ts)):
        assert np.array_equal(_as_np(a), _as_np(b))


def test_torn_newest_checkpoint_is_skipped(tmp_path):
    """A sentineled step whose shard file is torn is skipped with a
    warning; a step without the sentinel (a crash mid-save) is invisible;
    ``keep`` garbage-collects the oldest; a threaded save lands after
    ``wait``."""
    ck = Checkpointer(str(tmp_path), keep=2)
    ts = _torch_state()
    for step in (1, 2):
        ts["opt"]["count"] = torch.tensor(step, dtype=torch.int32)
        ck.save(step, ts)
    ts["opt"]["count"] = torch.tensor(3, dtype=torch.int32)
    ck.save(3, ts, blocking=False)
    ck.wait()
    assert ck.all_steps() == [2, 3]                  # keep=2: step 1 gone
    with open(tmp_path / "step_3" / "host_0" / "shards.npz", "r+b") as f:
        f.truncate(100)
    os.makedirs(tmp_path / "step_4" / "host_0")      # no COMPLETE sentinel
    assert ck.latest_step() == 3
    with pytest.warns(RuntimeWarning, match="step_3 unrestorable"):
        step, got = ck.restore_latest(_torch_state())
    assert step == 2 and int(got["opt"]["count"]) == 2
    assert torch.equal(got["params"]["w"], ts["params"]["w"])
    empty = Checkpointer(str(tmp_path / "none"))
    like = _torch_state()
    assert empty.restore_latest(like) == (None, like)


# ---------------------------------------------------------------------------
# the elastic loop and the CLI
# ---------------------------------------------------------------------------
def _args(tmp_path, steps, **kw):
    return tlaunch.parse_args(
        ["--reduced", "--device", "cpu", "--precision", "2xT", "--steps",
         str(steps), "--batch", "4", "--seq", "16", "--lr", "3e-3",
         "--save-every", "100", "--ckpt-dir", str(tmp_path)]
        + [f"--{k.replace('_', '-')}={v}" for k, v in kw.items()])


def test_elastic_resume_is_bit_equal_to_an_uninterrupted_run(tmp_path):
    """4 steps, then a restart that resumes at step 4 (params, adamw state
    and the data position from the checkpoint) and runs to 8: the same
    losses and the same final state, bit for bit, as 8 steps in one go."""
    first = tlaunch.train(_args(tmp_path / "a", 4))
    resumed = tlaunch.train(_args(tmp_path / "a", 8))
    whole = tlaunch.train(_args(tmp_path / "b", 8))
    assert first.status == resumed.status == whole.status == "done"
    assert len(first.metrics) == len(resumed.metrics) == 4
    assert first.metrics + resumed.metrics == whole.metrics
    a, b = tree_leaves(resumed.state), tree_leaves(whole.state)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    assert Checkpointer(str(tmp_path / "a")).all_steps() == [4, 8]


def test_preemption_checkpoints_at_the_step_boundary(tmp_path):
    """SIGTERM during step 2 (of 5): the step finishes, a checkpoint lands
    at step 3, and the trainer returns "preempted"; the previous handler
    is back afterwards."""
    ck = Checkpointer(str(tmp_path))
    old = signal.getsignal(signal.SIGTERM)

    def build(n_data, n_model):
        def step_fn(state, batch):
            if int(state["n"]) == 2:
                signal.raise_signal(signal.SIGTERM)
            return {"n": state["n"] + 1}, {"loss": 0.0}
        return None, {"n": torch.zeros((), dtype=torch.int64)}, None, step_fn

    data = tdata.SyntheticLM(vocab=50, seq_len=4, global_batch=2)
    state, metrics, status = ElasticTrainer(ck, build).run(5, 1, 1, data)
    assert status == "preempted" and len(metrics) == 3 and int(state["n"]) == 3
    assert ck.all_steps() == [3] and signal.getsignal(signal.SIGTERM) is old
    state, metrics, status = ElasticTrainer(ck, build).run(5, 1, 1, data)
    assert status == "done" and len(metrics) == 2 and int(state["n"]) == 5
    assert data.state_dict() == {"step": 5}


def test_train_cli_on_the_cpu(tmp_path, capsys):
    losses = tlaunch.main(["--reduced", "--device", "cpu", "--steps", "3",
                           "--batch", "4", "--seq", "16", "--optimizer",
                           "adam8bit", "--accum-steps", "2",
                           "--ckpt-dir", str(tmp_path)])
    assert len(losses) == 3 and all(np.isfinite(losses))
    out = capsys.readouterr().out
    assert out.startswith("status=done steps=3 ") and "last_loss=" in out
    run = tlaunch.train(_args(tmp_path / "c", 1))
    assert run.cfg.precision == "2xT" and len(run.step_ms) == 1


def test_train_cli_refuses_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--reduced", "--steps", "1",
                      "--ckpt-dir", str(tmp_path)])


def test_training_examples_run_on_the_cpu(capsys):
    """``examples/torch_train_qat.py`` at 100 steps: the loss's best
    25-step window lies below the first window (the example exits 1
    otherwise); ``examples/torch_widening_tradeoff.py`` at 2 steps a run:
    three finite eval losses with their modeled throughputs."""
    import importlib.util
    from pathlib import Path
    root = Path(__file__).resolve().parent.parent / "examples"

    def load(name):
        spec = importlib.util.spec_from_file_location(name, root / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    losses = load("torch_train_qat").main(["--device", "cpu", "--steps", "100"])
    assert len(losses) == 100 and all(np.isfinite(losses))
    assert "QAT @ 2xT: loss first" in capsys.readouterr().out
    runs = load("torch_widening_tradeoff").main(["--device", "cpu",
                                                 "--steps", "2"])
    assert [r[0] for r in runs] == ["fp32 1x", "2xT  1x", "2xT  2x"]
    assert all(np.isfinite(r[1]) and r[2] > 0 for r in runs)
