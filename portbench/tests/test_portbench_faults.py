"""Whole runs at tiny sizes on the CPU, past the chip check, with the timed
path broken underneath: each fault a cell can have must read ``correct``
false under the cell's own limits, by a number that the same run unbroken
keeps within its limit. The control (the reference in TF32) needs the
card: it is marked ``card``."""

import argparse
import importlib.util
import json

import pytest
import torch

from conftest import ROOT, tiny_cell
from portbench import compare, harness, workloads

_spec = importlib.util.spec_from_file_location("portbench_run", ROOT / "portbench" / "run.py")
run_module = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run_module)

TRAIN = ["adapointr_pcn.train_b16_disk", "imgencsegdec_pcn.train_b16_mem"]  # the first not yet a cell (PERF.md §7)
SERVE = ["imgencsegdec_pcn.serve_b32", "adapointr_pcn.serve_b32"]


def _measure(workload, monkeypatch, tmp_path):
    cell = tiny_cell(workload, tmp_path)
    result, checks = run_module.measure(cell, argparse.Namespace(seed=2**33 + 7, seconds=0.3, trace=0), "cpu",
                                        harness, torch.device("cpu"))
    return result["correct"], checks


def _state_unchanged(monkeypatch):
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def _half_the_batch(monkeypatch):
    from imgadapointr_tpu_torch.tools.runner import Runner

    step = Runner.train_step

    def half(self, batch, epoch_f, noise=None, aug=None):
        n = len(next(iter(batch.values()))) // 2
        return step(self, {k: v[:n] for k, v in batch.items()}, epoch_f, None if noise is None else noise[:n], aug)

    monkeypatch.setattr(Runner, "train_step", half)


def _answer_altered(monkeypatch):
    from imgadapointr_tpu_torch.tools.runner import Runner

    predict = Runner.predict

    def altered(self, batch):
        coarse, fine = predict(self, batch)
        fine = fine.clone()
        fine[0] += 0.01 * fine[0].abs().max()  # one cloud moved by a hundredth of its extent
        return coarse, fine

    monkeypatch.setattr(Runner, "predict", altered)


def _fails_what_sound_passes(workload, fault, monkeypatch, tmp_path):
    """The faulted run is not correct, and one of its numbers that fails
    its limit is under that limit in the same run unbroken."""
    _, sound = _measure(workload, monkeypatch, tmp_path)
    with monkeypatch.context() as m:
        fault(m)
        correct, broken = _measure(workload, m, tmp_path)
    assert not correct, broken
    caught = [k for k, c in broken.items() if c["value"] > c["limit"] >= sound[k]["value"]]
    assert caught, (sound, broken)


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch], ids=["state_unchanged", "half_the_batch"])
def test_a_training_fault_is_not_correct(workload, fault, monkeypatch, tmp_path):
    _fails_what_sound_passes(workload, fault, monkeypatch, tmp_path)


@pytest.mark.parametrize("workload", SERVE)
def test_an_altered_answer_is_not_correct(workload, monkeypatch, tmp_path):
    _fails_what_sound_passes(workload, _answer_altered, monkeypatch, tmp_path)


@pytest.mark.card
@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_the_control_is_not_correct(workload, card, tmp_path):
    """The reference in TF32 in the program's place, at the cell's widths
    with a batch of 2, fails the cell's limits."""
    cell = tiny_cell(workload, tmp_path)
    cell.config = json.loads((ROOT / "portbench" / "configs" / f"{workload.split('.')[0]}.json").read_text())
    cell.traffic = dict(cell.traffic, n_partial=2048, n_gt=16384)
    if "dataset" in cell.traffic:
        cell.traffic["dataset"] = dict(cell.traffic["dataset"], N_POINTS=16384)
    values = workloads.make(cell, 11, card, harness.Spans()).control()
    ok, checks = compare.verdict(values, cell.limits, cell.not_compared)
    assert not ok, checks
