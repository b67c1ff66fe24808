"""Port parity: ``repro_torch.runtime.serving.ContinuousBatcher`` against
``repro.runtime.serving.ContinuousBatcher`` on one ragged schedule (5
requests over 2 slots, reduced smollm at 2xT with an int8 KV cache, the
same serving params), plus the typed admission errors and the launcher."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_testing import one_thread  # noqa: E402,F401
import jax  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import reduce_for_smoke  # noqa: E402
from repro.models import to_serving as jto_serving  # noqa: E402
from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.interop import params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import reduce_for_smoke as treduce  # noqa: E402
from repro_torch.runtime import errors as terrors  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402

PROMPTS = [5, 11, 3, 16, 9]          # ragged: 1 or 2 chunks of 8
MAX_NEW = [4, 6, 3, 5, 4]


@pytest.fixture(autouse=True)
def _tuning_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TUNING_CACHE", str(tmp_path / "tuning.json"))


@pytest.fixture(scope="module")
def models():
    jcfg = reduce_for_smoke(jget_config("smollm-135m", precision="2xT",
                                        kv_bits=8))
    tcfg = treduce(get_config("smollm-135m", precision="2xT", kv_bits=8))
    jm = jbuild(jcfg)
    jsv = jto_serving(jm.init(jax.random.PRNGKey(0)), jcfg)
    tp = params_from_numpy(jax.tree_util.tree_map(np.array, jsv), "cpu")
    return jm, jsv, build_model(tcfg), tp


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, (1, n)).astype(np.int32) for n in PROMPTS]


def _serve(pkg, model, params, prompts, chunk_size):
    sc = pkg.ServingConfig(n_slots=2, s_max=24, chunk_size=chunk_size)
    batcher = pkg.ContinuousBatcher(model, params, sc)
    for rid, (toks, n) in enumerate(zip(prompts, MAX_NEW)):
        batcher.submit(pkg.Request(rid, toks,
                                   options=pkg.RequestOptions(max_new=n)))
    done = batcher.run()
    assert len(done) == len(prompts)
    return {r.rid: list(r.output) for r in done}, batcher.metrics


@pytest.mark.parametrize("chunk_size", [8, 0], ids=["chunked", "whole"])
def test_greedy_streams_match_reference(models, chunk_size):
    jm, jsv, tm, tp = models
    prompts = _prompts(tm.cfg.vocab)
    want, jmet = _serve(jserving, jm, jsv, prompts, chunk_size)
    got, tmet = _serve(tserving, tm, tp,
                       [p.astype(np.int64) for p in prompts], chunk_size)
    assert got == want
    assert [len(got[i]) for i in range(len(PROMPTS))] == MAX_NEW
    assert (tmet.decode_steps, tmet.prefill_chunks, tmet.prefill_full) == \
        (jmet.decode_steps, jmet.prefill_chunks, jmet.prefill_full)


@pytest.mark.parametrize("case", ["empty", "budget", "too_long"])
def test_admission_errors_match_reference(models, case):
    jm, jsv, tm, tp = models
    toks = {"empty": np.zeros((1, 0), np.int32),
            "too_long": np.zeros((1, 24), np.int32)}.get(
        case, np.zeros((1, 4), np.int32))
    max_new = 0 if case == "budget" else 4
    errs = []
    for pkg, model, params in ((jserving, jm, jsv), (tserving, tm, tp)):
        batcher = pkg.ContinuousBatcher(
            model, params, pkg.ServingConfig(n_slots=2, s_max=24))
        with pytest.raises(ValueError) as ei:
            batcher.submit(pkg.Request(
                7, toks, options=pkg.RequestOptions(max_new=max_new)))
        errs.append(ei.value)
    j, t = errs
    assert type(t).__name__ == type(j).__name__
    assert isinstance(t, terrors.AdmissionError)
    assert str(t) == str(j)
    assert {k: v for k, v in vars(t).items()} == \
        {k: v for k, v in vars(j).items()}


def test_sampling_is_refused(models):
    """Sampling is ported: submit no longer refuses temperature > 0, and the
    request is served (tests/test_torch_sampling.py holds the draws to the
    reference's)."""
    _, _, tm, tp = models
    batcher = tserving.ContinuousBatcher(
        tm, tp, tserving.ServingConfig(n_slots=2, s_max=24))
    batcher.submit(tserving.Request(
        0, np.zeros((1, 4), np.int64),
        options=tserving.RequestOptions(max_new=3, temperature=0.7)))
    (done,) = batcher.run()
    assert len(done.output) == 3


def test_write_slot_copies_one_slot(models):
    _, _, tm, _ = models
    from repro_torch.models import transformer as tfm
    slots = tfm.make_cache(tm.cfg, 3, 16, "cpu")
    one = tfm.make_cache(tm.cfg, 1, 24, "cpu")       # longer admission cache
    for leaf in one["layer_0"].values():
        leaf.fill_(5)
    tserving.write_slot(slots, one, 1)
    for leaf in slots["layer_0"].values():
        assert bool((leaf[:, 1] == 5).all())
        assert not bool((leaf[:, 0] == 5).any()) and \
            not bool((leaf[:, 2] == 5).any())


def test_launcher_cpu_and_no_card_refusal(capsys):
    done = tserve.main(["--reduced", "--device", "cpu", "--requests", "3",
                        "--slots", "2", "--prompt-len", "10", "--gen", "3"])
    assert sorted(len(r.output) for r in done) == [3, 3, 3]
    out = capsys.readouterr().out
    assert "weights:" in out and "kernel launches:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--reduced", "--requests", "1"])


def test_serving_config_is_required(models):
    _, _, tm, tp = models
    with pytest.raises(TypeError):
        tserving.ContinuousBatcher(tm, tp, dataclasses.asdict(
            tserving.ServingConfig()))
