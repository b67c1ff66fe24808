"""The port's copy of the paper's FPGA performance model
(``repro_torch.core.pe_model``) against ``repro.core.pe_model``: every
constant, table and function equal, over the paper's PE menu, both
devices and the widths of ``benchmarks/bench_fig6_widening.py``; and the
paper-claim checks of ``tests/test_cnn_and_paper_claims.py`` repeated on
the port's copy at the same tolerances."""
import dataclasses
import inspect

import pytest

from repro.core import pe_model as jpm
from repro_torch.core import pe_model as pm

DEVICES = ("ARRIA10", "STRATIX10")
WIDTHS = (1.0, 2.0, 3.0)          # bench_fig6_widening.py's widths (1, 2)
                                  # and Table IV's 3x column
CONSTANTS = ("PE_TABLE", "TABLE4_PE", "ALM_FRACTION", "FIT_EFFICIENCY",
             "MAPPING_EFF_DEFAULT", "MAPPING_EFF", "FP32_DSP_EFF", "S10_FMAX",
             "A10_FMAX_MEASURED", "TABLE4_RESNET34_1X", "TABLE4_WIDE",
             "TABLE4_ACC_WIDE", "TABLE5_S10_B1", "TABLE5_TITANX", "GOPS")


def _public(mod):
    """The module's own public names (no imported modules)."""
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)
            and n != "annotations"}


def test_same_public_names():
    assert _public(pm) == _public(jpm)


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_and_tables_equal(name):
    assert getattr(pm, name) == getattr(jpm, name)


@pytest.mark.parametrize("dev", DEVICES)
def test_devices_equal(dev):
    assert dataclasses.asdict(getattr(pm, dev)) == \
        dataclasses.asdict(getattr(jpm, dev))


@pytest.mark.parametrize("dev", DEVICES)
def test_every_function_equal(dev):
    d, jd = getattr(pm, dev), getattr(jpm, dev)
    assert pm.fp32_tops(d) == jpm.fp32_tops(jd)
    for gops in jpm.GOPS.values():
        assert pm.fp32_images_per_sec(d, gops) == \
            jpm.fp32_images_per_sec(jd, gops)
    for pe in jpm.PE_TABLE:
        for fmax in (jpm.S10_FMAX, jpm.A10_FMAX_MEASURED):
            assert pm.peak_tops(pe, d, fmax) == jpm.peak_tops(pe, jd, fmax)
        for w in WIDTHS:
            assert pm.eq_tops(pe, d, w) == jpm.eq_tops(pe, jd, w)
            for gops in jpm.GOPS.values():
                assert pm.images_per_sec(pe, d, gops, width_mult=w) == \
                    jpm.images_per_sec(pe, jd, gops, width_mult=w)


def test_layer_model_and_arria10_design_equal():
    for w in WIDTHS:
        layers = pm.alexnet_conv_fc_dims(w)
        assert layers == jpm.alexnet_conv_fc_dims(w)
        for lanes, words in ((471, 64), (100, 8), (2048, 32)):
            assert pm.cycles_per_image(layers, lanes, words) == \
                jpm.cycles_per_image(layers, lanes, words)
    for kw in ({}, {"alm_budget": 100_000}, {"fmax": 300e6},
               {"stall_factor": 1.0}):
        assert pm.a10_2xt_design(**kw) == jpm.a10_2xt_design(**kw)


def test_signatures_equal():
    for name in ("peak_tops", "fp32_tops", "eq_tops", "images_per_sec",
                 "fp32_images_per_sec", "alexnet_conv_fc_dims",
                 "cycles_per_image", "a10_2xt_design"):
        assert inspect.signature(getattr(pm, name)).parameters.keys() == \
            inspect.signature(getattr(jpm, name)).parameters.keys()


# ---------------------------------------------------------------------------
# the paper's claims (tests/test_cnn_and_paper_claims.py), on the port's copy
# ---------------------------------------------------------------------------
def test_table4_within_10pct():
    for (a, w), (paper_tops, _) in pm.TABLE4_RESNET34_1X.items():
        model = pm.fp32_tops(pm.STRATIX10) if a == "fp32" else \
            pm.peak_tops(pm.TABLE4_PE[(a, w)], pm.STRATIX10)
        assert abs(model / paper_tops - 1) < 0.10, (a, w, model, paper_tops)


def test_table5_within_15pct():
    for (a, w), row in pm.TABLE5_S10_B1.items():
        for net, paper in zip(("resnet34", "resnet50", "alexnet"), row):
            m = pm.fp32_images_per_sec(pm.STRATIX10, pm.GOPS[net]) \
                if a == "fp32" else \
                pm.images_per_sec(pm.TABLE4_PE[(a, w)], pm.STRATIX10,
                                  pm.GOPS[net])
            assert abs(m / paper - 1) < 0.15, (a, w, net, m, paper)


def test_table3_arria10_poc():
    d = pm.a10_2xt_design()
    assert abs(d["images_per_sec"] / 3700 - 1) < 0.15
    assert abs(d["alms"] / 150_000 - 1) < 0.05


def test_widening_eq_tops_normalization():
    """§IV.C: 2x/3x-wide performance divides by 4/9."""
    pe = pm.TABLE4_PE[("2", "T")]
    base = pm.peak_tops(pe, pm.STRATIX10)
    assert pm.eq_tops(pe, pm.STRATIX10, 2.0) == pytest.approx(base / 4)
    assert pm.eq_tops(pe, pm.STRATIX10, 3.0) == pytest.approx(base / 9)


def test_alexnet_widening_keeps_first_conv_and_classifier():
    base, wide = pm.alexnet_conv_fc_dims(1.0), pm.alexnet_conv_fc_dims(2.0)
    assert wide[0]["C"] == base[0]["C"] == 3
    assert wide[-1]["K"] == base[-1]["K"] == 1000
    assert [lw["K"] for lw in wide[:5]] == [2 * lb["K"] for lb in base[:5]]
