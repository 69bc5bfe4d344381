"""The plain reference against the port at tiny widths on the CPU (the port
runs its kernels' plain versions there): the eval clouds, and one train
step's losses and gradients, from the same weights and draws."""

import argparse

import pytest
import torch

from conftest import tiny_config
from portbench import compare, weights
from portbench.reference import models, nets

MODELS = [("adapointr_pcn", "AdaPoinTr"), ("imgencsegdec_pcn", "ImgEncSegDecAdaPoinTrVariableLoss")]


def _both(config, name, seed=3):
    from imgadapointr_tpu_torch.tools.runner import Runner
    from imgadapointr_tpu_torch.utils.config import AttrDict

    run_cfg = tiny_config(config)["run"]
    cfg = run_cfg["model"]
    runner = Runner(argparse.Namespace(seed=seed, device="cpu", tp=1, sp=1), AttrDict(run_cfg))
    w = weights.make(name, cfg, seed, torch.device("cpu"))
    weights.load(runner.model, w)
    ref = nets.load(name).build(cfg)
    weights.load(ref, weights.make(name, cfg, seed, torch.device("cpu")))
    g = torch.Generator().manual_seed(seed)
    batch = {"partial": torch.rand(2, 128, 3, generator=g) - 0.5, "gt": torch.rand(2, 256, 3, generator=g) - 0.5}
    if name != "AdaPoinTr":
        batch["img"] = torch.rand(2, 224, 224, 3, generator=g)
        batch["cls_vec"] = torch.eye(16)[:2]
    return runner, ref, batch


@pytest.mark.parametrize("config,name", MODELS)
def test_eval_clouds_agree(config, name):
    runner, ref, batch = _both(config, name)
    coarse, fine = runner.predict(batch)
    ref.eval()
    with torch.no_grad():
        rc, rf = ref(*[batch[k] for k in runner.model.inputs])
    torch.testing.assert_close(coarse, rc, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fine, rf, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("config,name", MODELS)
def test_train_step_agrees(config, name):
    runner, ref, batch = _both(config, name)
    noise = torch.randn(2, models.DENOISE_LENGTH, 3, generator=torch.Generator().manual_seed(1))
    model = runner.model
    model.train()
    ret = model(*[batch[k] for k in model.inputs], generator=runner.generator, noise=noise)
    losses = model.loss(ret, batch["gt"], 0.5)
    sum(losses).backward()
    ref.train()
    ref_ret = ref(*[batch[k] for k in model.inputs], noise=noise)
    ref_losses = ref.loss(ref_ret, batch["gt"], 0.5)
    sum(ref_losses).backward()
    for a, b in zip(losses, ref_losses):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    grads = {n: float(p.grad.norm()) for n, p in model.named_parameters() if p.grad is not None}
    ref_grads = {n: float(p.grad.norm()) for n, p in ref.named_parameters() if p.grad is not None}
    assert set(grads) == set(ref_grads)
    # by the benchmark's own measure, not elementwise: a max over neighbours
    # that two float32 forms of one edge convolution see nearly tied sends a
    # few entries' gradient to another neighbour (3e-3 of a leaf here); in the
    # superset, GDANet's top-k selections flip on such ties too, and the
    # gradient through its other picks reaches every leaf upstream (1.5e-2)
    gap, leaf = compare.norm_gap(grads, ref_grads)
    assert gap < (1e-2 if name == "AdaPoinTr" else 5e-2), leaf


@pytest.mark.parametrize("config,name", MODELS)
def test_state_dict_layout_equal(config, name):
    runner, ref, _ = _both(config, name)
    port = {n: tuple(p.shape) for n, p in runner.model.state_dict().items()}
    mine = {n: tuple(p.shape) for n, p in ref.state_dict().items()}
    assert port == mine
