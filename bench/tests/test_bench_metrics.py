"""Each per-layer reader (``metrics/<name>.py``) on a small synthetic
trace, the trace arithmetic of ``devtrace``, and nothing read where there
is nothing to read."""
from __future__ import annotations

import pytest
from bench_testing import BENCH, ROOT

import costs
import devtrace
from devtrace import DeviceOp, HostEvent

QMM = "void (anonymous namespace)::qmm_int8_mma_kernel<2, 16>(signed char const*, int const*)"
AQ = "void (anonymous namespace)::act_quant_rows_kernel<float, 1>(float const*, signed char*)"
EW = "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::Mul>>(int)"
D2H = "Memcpy DtoH (Device -> Pageable)"


def _trace(batches: int = 2) -> devtrace.Trace:
    """Per batch of 100 us: B1 10-20, B7c 20-25, a PyTorch kernel 25-60, a
    fill 60-62, and the harness's copy of the logits 85-90 in its sync."""
    ops, host = [], []
    for b in range(batches):
        t = 100.0 * b
        ops += [DeviceOp(QMM, "kernel", t + 10, t + 20),
                DeviceOp(AQ, "kernel", t + 20, t + 25),
                DeviceOp(EW, "kernel", t + 25, t + 60),
                DeviceOp("Memset (Device)", "memset", t + 60, t + 62),
                DeviceOp(D2H, "memcpy", t + 85, t + 90)]
        host += [HostEvent(devtrace.BATCH, t, t + 100),
                 HostEvent(devtrace.PICK, t, t + 1),
                 HostEvent(devtrace.FORWARD, t + 1, t + 80),
                 HostEvent("aten::mul", t + 62, t + 70),
                 HostEvent(devtrace.SYNC, t + 80, t + 100),
                 HostEvent("cudaMemcpyAsync", t + 80, t + 99)]
    return devtrace.Trace(sorted(ops, key=lambda o: o.start),
                          sorted(host, key=lambda h: h.start))


LAYERS = [costs.Layer("conv.0", 100, 64, 363, 1000, 2, True),
          costs.Layer("conv.1", 100, 192, 1600, 1000, 2, True),
          costs.Layer("head", 1, 10, 64, 64, 32, False)]


def _run(trace=None, images_per_s=1000.0):
    return devtrace.Run(trace or _trace(), LAYERS, 1, images_per_s,
                        frozenset({"qmm_int8_mma_kernel",
                                   "act_quant_rows_kernel"}))


def _reader(name):
    import run
    return run.load_module("metrics", name).read


def test_device_ops_leave_out_the_harness_copy():
    assert _reader("device_ops_per_batch")(_run()) == 4


def test_native_time_is_all_but_the_program_kernels():
    assert _reader("native_ms_per_batch")(_run()) == pytest.approx(0.037)


def test_act_quant_time():
    assert _reader("act_quant_ms_per_batch")(_run()) == pytest.approx(0.005)


def test_device_idle_is_the_union_of_intervals():
    # busy 10-62 and 85-90 of each 100 us
    assert _reader("device_idle_pct")(_run()) == pytest.approx(43.0)


def test_qmatmul_roofline_counts_the_layers_the_kernel_ran():
    # one launch a forward: the one quantized layer whose K packs (1600)
    want = 100 * costs.bound_s(LAYERS[1]) / 10e-6
    assert _reader("qmatmul_roofline")(_run()) == pytest.approx(want)


def test_qmatmul_roofline_is_silent_when_launches_match_no_layers():
    t = _trace()
    extra = [DeviceOp(QMM, "kernel", 100 * b + 62, 100 * b + 64)
             for b in range(2)] * 2
    t = devtrace.Trace(sorted(t.ops + extra, key=lambda o: o.start), t.host)
    assert _reader("qmatmul_roofline")(_run(t)) is None


def test_forward_mfu():
    per_image = costs.model_ops(LAYERS)
    want = 100 * per_image * 1000.0 / costs.PEAK_INT8_OPS
    assert _reader("forward_mfu")(_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["device_ops_per_batch", "native_ms_per_batch",
                                  "act_quant_ms_per_batch", "device_idle_pct",
                                  "qmatmul_roofline", "forward_mfu"])
def test_nothing_to_read_gives_nothing(name):
    empty = devtrace.Trace([], [])
    assert _reader(name)(_run(empty, images_per_s=0.0)) is None


def test_breakdown_names_the_host_in_each_gap():
    bd = devtrace.breakdown(_trace())
    assert bd["device_ops"][0] == [EW, pytest.approx(70e-6)]
    labels = {name for name, _ in bd["idle_gaps"]}
    assert "bench.forward/aten::mul" in labels
    assert "bench.sync/cudaMemcpyAsync" in labels
    longest = max(s for _, s in bd["idle_gaps"])
    assert longest == pytest.approx(23e-6)          # 62 -> 85
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_kernel_base_names():
    assert devtrace.kernel_base(QMM) == "qmm_int8_mma_kernel"
    assert devtrace.kernel_base(EW) == "elementwise_kernel"
    assert devtrace.kernel_base("sm90_xmma_gemm_f64f64_f64f64_f64_tn_n") == \
        "sm90_xmma_gemm_f64f64_f64f64_f64_tn_n"


def test_port_kernels_are_read_from_the_sources():
    names = devtrace.port_kernels(ROOT / "src" / "repro_torch" / "csrc")
    assert {"qmm_int8_mma_kernel", "qmm_int8_rows_kernel",
            "act_quant_rows_kernel"} <= names
    assert not any(n.startswith("void") for n in names)
    assert BENCH.is_dir()
