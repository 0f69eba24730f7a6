"""The correctness check on the CPU at a size a test run holds: the
control (the reference computed in bfloat16, put in the program's
place) fails the cell's limits, a sound run passes them, and runs of
the harness with the program broken underneath come out not correct,
once for each fault these cells can have (one chip: no exchange
between chips to leave out)."""

import json

import numpy as np
import pytest
import torch

from kcmc_bench import gen, run
from kcmc_bench.reference import compare, oracle
from kcmc_tpu_torch.backends import torch_backend

SIZES = {"affine2k.rec512": 128, "affine2k.cam1024": 128, "piecewise8x8.rec512": 256}


def tiny_cell(name: str) -> run.Cell:
    """The cell with its real limits and settings, at a test's size: a
    few frames, batch 8, 256 keypoints for the affine configuration.
    The configuration's stated rmse limit holds at the cell's size only
    (at 128 px an 8x8 grid cell holds a handful of keypoints), so it is
    lifted here; the gap limits are the cell's own."""
    cell = run.Cell(name)
    size = SIZES[name]
    cell.traffic = dict(cell.traffic, shape=[size, size], frames=8, distinct=8,
                        check_frames=3, trace_min_s=0.1)
    over = {"batch_size": 8}
    if cell.config["settings"]["model"] == "affine":
        over["max_keypoints"] = 256
    cell.config = dict(cell.config, corrector={**cell.config["corrector"], **over},
                       settings={**cell.config["settings"], **over},
                       rmse={**cell.config["rmse"], "limit_px": 10.0})
    return cell


def ratio_cell(name: str) -> run.Cell:
    """The cell at a test's size with its recording's proportions: its
    frames, distinct frames and batch cut by one factor to a batch of 4
    (cam1024's 256, 64 and 32 to 32, 8 and 4), its own number of
    sampled frames and, for the affine configuration, its stated rmse
    limit (sound runs read 0.015-0.018 px at 128 px)."""
    cell = tiny_cell(name)
    real = run.Cell(name)
    cut = int(real.config["settings"]["batch_size"]) // 4
    cell.traffic = dict(cell.traffic, frames=int(real.traffic["frames"]) // cut,
                        distinct=int(real.traffic["distinct"]) // cut,
                        check_frames=int(real.traffic["check_frames"]))
    over = {"batch_size": 4}
    cell.config = dict(cell.config, corrector={**cell.config["corrector"], **over},
                       settings={**cell.config["settings"], **over}, rmse=real.config["rmse"])
    return cell


def run_cell(name, capsys, cell=None, seed=2147483659):
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "0.1",
                   "--trace", "0"], device="cpu", cell=cell or tiny_cell(name))
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_the_limits(name, torch_threads):
    cell = tiny_cell(name)
    settings = oracle.Settings(cell.config["settings"])
    stack, _ = gen.recording(cell.config["scene"], cell.traffic, 7)
    frames = compare.sample_frames(7, len(stack), 3)
    reference = compare.reference_runs(stack, frames, settings)
    low = compare.judge(stack, compare.control_samples(stack, frames, settings), reference,
                        settings)
    assert set(low) == set(cell.limits)
    for k, v in low.items():
        assert v > 3 * cell.limits[k], (k, v)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_sound_run_passes(name, capsys, torch_threads):
    line = run_cell(name, capsys)
    assert line["correct"], line["checks"]
    assert list(line["checks"]) == ["settings_differ", "ladder_frames", "rmse_px",
                                    *tiny_cell(name).limits]


def identity_warp(self, shape):
    def warp(frames, motion):
        return frames.clone(), torch.ones(frames.shape[0], dtype=torch.bool)
    return warp


def half_left_out(tail):
    def broken(self, frames, *args, **kwargs):
        out = tail(self, frames, *args, **kwargs)
        h = frames.shape[0] // 2
        out["corrected"] = out["corrected"].clone()
        out["corrected"][h:] = 0.0
        key = "field" if "field" in out else "transform"
        out[key] = out[key].clone()
        out[key][h:] = 0.0 if key == "field" else torch.eye(3)
        return out
    return broken


def altered(tail):
    def broken(self, frames, *args, **kwargs):
        out = tail(self, frames, *args, **kwargs)
        key = "field" if "field" in out else "transform"
        out[key] = out[key].clone()
        if key == "field":
            out[key] = out[key] + 0.05
        else:
            out[key][:, 0, 2] += 0.05
        return out
    return broken


FAULTS = {
    # the warp step returns its input unchanged
    "state_unchanged": lambda mp, tail: [
        mp.setattr(torch_backend.TorchBackend, "_resolve_batch_warp", identity_warp),
        mp.setattr(torch_backend.TorchBackend, "_resolve_field_warp", identity_warp)],
    # half of each batch left out: its frames zero, its motion none
    "half_batch": lambda mp, tail: mp.setattr(torch_backend.TorchBackend, tail,
                                              half_left_out(getattr(torch_backend.TorchBackend,
                                                                    tail))),
    # an answer altered where it is produced: 0.05 px more motion
    "answer_altered": lambda mp, tail: mp.setattr(torch_backend.TorchBackend, tail,
                                                  altered(getattr(torch_backend.TorchBackend,
                                                                  tail))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(SIZES))
def test_broken_program_is_not_correct(name, fault, capsys, monkeypatch, torch_threads):
    tail = "_piecewise_tail" if name.startswith("piecewise") else "_matrix_tail"
    FAULTS[fault](monkeypatch, tail)
    line = run_cell(name, capsys)
    assert not line["correct"], line["checks"]
    np.testing.assert_array_equal(line["failed"], 0)


@pytest.mark.parametrize("seed", [2147483659, 3000000019, 4000000007])
def test_half_batch_is_not_correct_at_cell_proportions(seed, capsys, monkeypatch,
                                                      torch_threads):
    """Half of every batch left out, at cam1024's proportions, where the
    sampled frames can all fall in first halves: every frame of the last
    call is held against the truth, so each seed sees it."""
    name = "affine2k.cam1024"
    cell = ratio_cell(name)
    assert cell.traffic["distinct"] > 2 * cell.config["settings"]["batch_size"] - 1
    FAULTS["half_batch"](monkeypatch, "_matrix_tail")
    line = run_cell(name, capsys, cell, seed)
    assert not line["correct"], line["checks"]
    assert line["checks"]["rmse_px"]["value"] > line["checks"]["rmse_px"]["limit"]


def test_sound_run_passes_at_cell_proportions(capsys, torch_threads):
    line = run_cell("affine2k.cam1024", capsys, ratio_cell("affine2k.cam1024"))
    assert line["correct"], line["checks"]
