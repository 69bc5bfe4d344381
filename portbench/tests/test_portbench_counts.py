"""The yardstick's arithmetic against hand counts: model FLOPs against
``torch``'s own FLOP counter on the reference, kernel bounds against sums
written out, the trace's reduction against a trace made by hand."""

import types

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_config
from portbench.reference import bounds, flops, models, nets, profile

MODELS = [("adapointr_pcn", "AdaPoinTr"), ("imgencsegdec_pcn", "ImgEncSegDecAdaPoinTrVariableLoss")]


def _inputs(name, n, g):
    x = [torch.rand(1, n, 3, generator=g)]
    if name != "AdaPoinTr":
        x += [torch.rand(1, 224, 224, 3, generator=g), torch.eye(16)[:1]]
    return x


@pytest.mark.parametrize("config,name", MODELS)
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_flops_equal_torch_flop_counter(config, name, train):
    cfg = tiny_config(config)["run"]["model"]
    g = torch.Generator().manual_seed(0)
    net = nets.load(name)
    model = net.build(cfg)
    for p in model.parameters():
        p.data.normal_(0, 0.1, generator=g)
    n = 64
    x = _inputs(name, n, g)
    model.train(train)
    with FlopCounterMode(display=False) as fc:
        if train:
            ret = model(x[0], *x[1:], noise=torch.randn(1, models.DENOISE_LENGTH, 3, generator=g))
            gt = torch.rand(1, 256, 3, generator=g)
            sum(model.loss(ret, gt, 0.0)).backward()
        else:
            model(x[0], *x[1:])
    assert fc.get_total_flops() == net.step_flops(cfg, n, train)


def test_flop_count_by_hand():
    c = flops.Count()
    c.linear(10, 3, 4)  # 240 forward, its two gradients
    c.linear(10, 3, 4, x_grad=False)  # 240, the weight's gradient only
    c.linear(10, 3, 4, frozen=True)  # 240, the input's gradient only
    assert (c.fwd, c.bwd) == (720, 960)


def test_kernel_bounds_by_hand():
    p = 1234  # a pointer
    B, M, S, k = 2, 8, 4, 3
    assert bounds.work("knn_f32", (p, p, p, p, None, B, M, S, k, 1)) == (12 * 2 * 12 + 12 * 2 * 4 * 3, 9 * 2 * 4 * 8)
    assert bounds.work("fps_f32", (p, p, 2, 100, 10)) == (12 * 2 * 100 + 8 * 2 * 10, 10 * 2 * 9 * 100)
    assert bounds.work("gather_rows_f32", (p, p, p, 2, 100, 10, 3)) == (8 * 20 + 4 * 20 * 3 + 4 * 20 * 3, 0)
    assert bounds.work("scatter_add_rows_f32", (p, p, p, None, 1, 6, 4, 2)) == (48 + 48 + 32, 12)
    assert bounds.work("nn_bidir_argmin_f32", (p, p, p, 1, 5, 7)) == (20 * 12, 10 * 35)
    assert bounds.work("weighted_gather_sum_f32", (p, p, p, p, 1, 4, 3, 100, 2)) == (12 * 12 + 4 * 12 * 2 + 4 * 4 * 2,
                                                                                      2 * 12 * 2)
    assert bounds.work("auction_top2_f32", (p,) * 8 + (1, 2, 3, 4)) is None
    assert bounds.least_seconds(3.35e12, 0) == 1.0 and bounds.least_seconds(0, 67e12) == 1.0


@pytest.mark.parametrize("name,kernel", [
    ("void knn_kernel<8>(float const*, float const*, float*, long*, uint2*, int, int)", "knn"),
    ("knn_merge_kernel(uint2 const*, float*, long*, int, int, int)", "knn"),
    ("void (anonymous namespace)::fps_kernel<512, 4>(float const*, long*, int, int)", "fps"),
    ("nn_bidir_kernel_unpack(unsigned long*, long)", "nn_bidir_argmin"),
    ("void gather_rows_kernel<float>(float const*, long const*, float*, long, long, long, long)", "gather_rows"),
    ("ampere_sgemm_128x64_nn", None),
    ("nn_bidir_mxu_kernel(float const*)", "nn_bidir_mxu"),
])
def test_kernel_names(name, kernel):
    assert bounds.kernel_of(name) == kernel


def _event(name, start, end, device, annotation=False):  # a raw profiler event, times in us
    return types.SimpleNamespace(name=lambda: name, device_type=lambda: device, is_user_annotation=lambda: annotation,
                                 start_ns=lambda: start * 1000, duration_ns=lambda: (end - start) * 1000)


def test_trace_reduction_by_hand():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [_event("a", 0, 10, cuda), _event("b", 5, 20, cuda), _event("a", 30, 40, cuda),
              _event("aten::mm", 0, 1, cpu), _event("cudaLaunchKernel", 2, 3, cpu),
              _event("portbench.train_step", 50, 60, cuda, annotation=True)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    intervals = profile.device_intervals(prof)
    assert [n for _, _, n in intervals] == ["a", "b", "a"]
    spans = [(18_000, 35_000, "loader_wait"), (0, 17_000, "train_step")]
    red = profile.reduce(intervals, 1e-4, spans)
    assert red["busy_s"] == pytest.approx(30e-6)
    assert red["launches"] == 3
    assert red["by_name"] == pytest.approx({"a": 20e-6, "b": 15e-6})
    assert red["idle_gaps"] == [(pytest.approx(10e-6), "loader_wait")]
    assert profile.reduce(intervals, 1e-4, [])["idle_gaps"] == [(pytest.approx(10e-6), profile.OUTSIDE)]


def test_idle_share_takes_its_time_from_the_untraced_stretch():
    from portbench import harness

    profile_red = {"busy_s": 3.0, "window_s": 5.0, "by_name": {}, "launches": 0}
    traced = {"units": 30, "clouds": 480}
    untraced = {"seconds": 20.0, "units": 160, "clouds": 2560}
    r = harness.Readings(profile_red, [], harness.Spans(), traced, untraced, 1.0, 0)
    assert r.idle_pct() == pytest.approx(100.0 * (1.0 - 0.1 / 0.125))  # 100 ms busy in 125 ms a step
    assert harness.Readings(profile_red, [], harness.Spans(), traced, None, 1.0, 0).idle_pct() == pytest.approx(40.0)


@pytest.mark.parametrize("value,over", [(99.9, False), (100.2, True)])
def test_a_share_above_100_is_an_error(value, over):
    from portbench import harness

    metrics = {"mfu.train": {"value": value, "unit": "%", "peak": "67 TFLOP/s"}, "launches.train": {"value": 4082.0}}
    assert bool(harness.shares_over_100(metrics)) == over
