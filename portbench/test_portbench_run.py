"""A run end to end on the CPU at a tiny geometry (the port's ``device="cpu"``
path, the kernels' plain twins): the result line's schema, the reference
against the port in all three clone modes, the control failing the
comparison, and each fault a cell can have turning ``correct`` false.

The card's look is skipped (``harness.run_cell`` with ``device="cpu"``);
everything after it runs as on the card. Tests that need the card are
marked ``cuda`` and skip here."""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import pytest
import torch

from portbench import calibrate, harness, load
from portbench.traffic import Request, Reservoir

ROOT = Path(__file__).resolve().parent.parent
SEED = 2**31 + 77
TINY = {"src_hw": [40, 52], "dst_hw": [80, 100]}
# the control's errors grow with the grid: at 156 x 206 the TF32 reference
# reads above the headline cells' limits, and ten times the port's gap
# at least, but under the 8K cell's limits (which hold on the card, below)
SMALL = {"src_hw": [160, 210], "dst_hw": [240, 300]}


def _cfg(cell, size=TINY):
    cfg = dict(load.config(load.cell(cell)["config"]), **size)
    if cfg["path"] == "mg_q":  # the tiny grid is under the crossover
        cfg["clone_config"] = {"solver": "multigrid"}
    return cfg


def _spec(cell, **kw):
    return dict(load.traffic(load.cell(cell)["traffic"]), sample=3, trace_requests=2, **kw)


def _run(cell, traced=False, seconds=0.3):
    return harness.run_cell(cell, SEED, seconds, traced, "cpu", time.perf_counter(),
                            tempfile.gettempdir(), _cfg(cell), _spec(cell))


CELLS = [w["name"] for w in load.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_result_line_schema(cell, traced):
    r = _run(cell, traced)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    entry = load.cell(cell)
    want = entry["per_layer"] if traced else entry["end_to_end"]
    units = {m["name"]: m["unit"] for m in want}
    assert set(r["metrics"]) <= set(units)
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == units[name]
        assert isinstance(m["value"], float | int)
    if not traced:
        assert set(r["metrics"]) == set(units)
    dev = r["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if traced:
        assert dev["window_s"] > 0 and "busy_s" in dev
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in r["breakdown"].values())
    assert set(r["checks"]) == set(load.limits(cell)["numbers"])
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed",
                        str(SEED), "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2 and p.stdout == ""


def test_a_card_that_cannot_be_read_fails_the_run(monkeypatch):
    def no_smi(*args, **kwargs):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(harness.subprocess, "run", no_smi)
    with pytest.raises(FileNotFoundError):
        harness.card()


@pytest.mark.parametrize("flags", [1, 2, 3])
@pytest.mark.parametrize("frames", [1, 4])
def test_reference_against_the_port_in_every_mode(flags, frames):
    cell = harness.prepare("headline-modes16", SEED, "cpu", _cfg("headline-modes16"),
                           _spec("headline-modes16"))
    req = Request(0, 0, flags, frames)
    out, _ = cell.call(req)
    row = harness.judge(cell, [out], harness.references(cell, [(req, out)]))[0]
    # the port solves in float32, the reference in float64: a truncation
    # may land one level apart
    assert row["max_abs_diff"] <= 1 and row["pct_off_by_2"] == 0


def _sample(cell_name, size):
    cell = harness.prepare(cell_name, SEED, "cpu", _cfg(cell_name, size), _spec(cell_name))
    sampler = Reservoir(cell.traffic.sample, SEED)
    harness.serve(cell, 0.3, sampler)
    return cell, sampler.items, harness.references(cell, sampler.items)


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_reads_far_off(cell_name):
    cell, samples, refs = _sample(cell_name, SMALL)
    limits = load.limits(cell_name)
    sound = harness.worst(harness.judge(cell, [o for _, o in samples], refs))
    assert harness.verdict(sound, limits)[0]
    got = calibrate.controls(cell, samples, refs)
    for name, numbers in got.items():
        assert numbers["mean_abs_diff"] >= 10 * sound["mean_abs_diff"], name
        if cell.cfg["path"] == "dst_pair":
            assert not harness.verdict(numbers, limits)[0], name


def _frame_unchanged(monkeypatch):
    from seamlesscloneoptimization_tpu_torch.core import engine

    monkeypatch.setattr(engine, "clone_pipeline", lambda src, dst, *a, **k: dst)


def _answer_altered(monkeypatch):
    """Each frame's pasted interior two levels off where it is produced: on
    the serve loop's planar (C, H, W) buffer or ``run``'s (H, W, C) image."""
    from seamlesscloneoptimization_tpu_torch.core import engine

    real = engine.clone_pipeline

    def altered(src, dst, mask, bbox_xy, left_top, *a, bbox_hw, **k):
        out = real(src, dst, mask, bbox_xy, left_top, *a, bbox_hw=bbox_hw, **k)
        (left, top), (bh, bw) = left_top, bbox_hw
        rows, cols = slice(top + 1, top + bh - 1), slice(left + 1, left + bw - 1)
        roi = out[:, rows, cols] if k.get("planar_dst") else out[rows, cols, :]
        roi.copy_(roi.clamp(max=253) + 2)
        return out

    monkeypatch.setattr(engine, "clone_pipeline", altered)


def _half_the_frames(monkeypatch):
    """Half of a request's frames left out: ``timed_serve`` chains half of
    its loops, and every second ``run`` (the drop-in's too, its destination
    a host array) returns its destination unchanged."""
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

    real_serve, real_run = SeamlessClone.timed_serve, SeamlessClone.run
    runs = []

    def run(self, src, dst, *a, **k):
        runs.append(None)
        if len(runs) % 2 == 0:
            return torch.as_tensor(dst).clone()
        return real_run(self, src, dst, *a, **k)

    monkeypatch.setattr(SeamlessClone, "timed_serve",
                        lambda self, *a, loops=20, **k: real_serve(self, *a, loops=loops // 2, **k))
    monkeypatch.setattr(SeamlessClone, "run", run)


@pytest.mark.parametrize("cell_name", CELLS)
@pytest.mark.parametrize("fault", [_frame_unchanged, _answer_altered, _half_the_frames])
def test_a_broken_timed_path_reads_not_correct(cell_name, fault, monkeypatch):
    """Each fault a cell can have: a frame that leaves its state unchanged,
    an answer altered where it is produced, half of a request's frames left
    out. (One card: no exchange between chips to leave out.)"""
    fault(monkeypatch)
    r = _run(cell_name)
    assert r["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_fails_at_the_cells_size_on_the_card(cell_name):
    """``calibrate.readings`` at the cell's own size, three seeds: the
    program passes, every control fails."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    limits = load.limits(cell_name)
    engine = None
    for seed in (SEED, SEED + 1, SEED + 2):
        row, engine = calibrate.readings(cell_name, seed, 2.0, engine=engine)
        assert harness.verdict(row["program"], limits)[0]
        for k, v in row.items():
            if k.startswith("control"):
                assert not harness.verdict(v, limits)[0], (k, v)


def test_witness_reads_the_program_one_step_from_its_own_frames():
    """``witness.py`` on the CPU: the first frame agrees with every
    reference, and each chained frame with one float64 frame run on the
    program's frame before it."""
    from portbench import witness

    row = witness.readings("headline-modes16", SEED, 2, 4, "cpu", _cfg("headline-modes16"))
    assert len(row["pairs"]) == load.traffic("modes16")["pool"]
    for pair in row["pairs"]:
        assert set(pair) == {1, 2, 4, "one_step_worst"}
        assert pair[1]["program"]["max_abs_diff"] <= 1
        assert pair[1]["ref_float32"]["max_abs_diff"] <= 1
        assert pair["one_step_worst"]["max_abs_diff"] <= 1
