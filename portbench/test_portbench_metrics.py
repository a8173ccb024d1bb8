"""The reduction from a profile to the per-layer metrics, on a hand-made
trace whose answers are worked out below and on a trace recorded on the
card; and the kernels' cost files at the cells' sizes."""

import json
import re
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import geometry, load, trace

HERE = Path(__file__).resolve().parent
HEADLINE = {"c": 3, "bh": 1550, "bw": 2398, "h": 1548, "w": 2396, "path": "dst_pair"}
PANO8K = {"c": 3, "bh": 2800, "bw": 3800, "h": 2798, "w": 3798, "path": "mg_q"}


def _ev(cat, name, ts, dur, tid=1, pid=1):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid, "tid": tid}


def _hand_trace():
    """Two requests of 2 frames each. Request 1: span 0-100; the host runs
    outside torch ops until 10, then aten::copy_ 10-20 (its cudaMemcpyAsync
    12-14 inside), aten::mm 30-40 (aten::addmm nested 31-39), a
    cudaDeviceSynchronize 60-100. Device: a copy 15-25, a GEMM 35-55, an
    erode3 kernel 50-60 (overlapping the GEMM), idle from 60 to 100.
    Request 2: span 200-300, host outside torch ops until 240, one kernel
    240-280, a synchronise 280-300."""
    return [
        _ev("user_annotation", trace.SPAN, 0, 100),
        _ev("cpu_op", "aten::copy_", 10, 10),
        _ev("cuda_runtime", "cudaMemcpyAsync", 12, 2),
        _ev("cpu_op", "aten::mm", 30, 10),
        _ev("cpu_op", "aten::addmm", 31, 8),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 60, 40),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 15, 10, tid=7, pid=0),
        _ev("kernel", "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x64x8", 35, 20, 7, 0),
        _ev("kernel", "void (anonymous namespace)::erode3_kernel<8>(unsigned char const*)",
            50, 10, 7, 0),
        _ev("gpu_user_annotation", trace.SPAN, 15, 85, 7, 0),
        _ev("user_annotation", trace.SPAN, 200, 100),
        _ev("kernel", "void (anonymous namespace)::erode3_kernel<8>(unsigned char const*)",
            240, 40, 7, 0),
        _ev("cuda_runtime", "cudaDeviceSynchronize", 280, 20),
    ]


def _summary(events, frames=4, geom=HEADLINE, launches=None):
    return trace.summarize(events, frames, geom, load.kernel_costs(), load.peaks(),
                           launches or {"erode3": 2, "fold_minor": 0})


def _read(name, s):
    return load.metric_reader(name).read(s)


def test_reduction_of_a_hand_made_trace():
    s = _summary(_hand_trace())
    assert s["requests"] == 2 and s["frames"] == 4
    assert s["window_us"] == 300
    assert s["busy_us"] == 10 + 25 + 40  # 15-25, 35-60 merged, 240-280
    assert s["host_us"] == [15, 40]
    assert s["aten_ops"] == 2  # aten::addmm sits inside aten::mm
    assert s["gemm_us"] == 20
    assert s["device_ops"]["(anonymous namespace)::erode3_kernel<8>"] == [50, 2]
    assert s["kernels"]["erode3"]["launches"] == 2 and s["kernels"]["erode3"]["us"] == 50
    idle = s["idle_by_host"]
    # the device idles 0-15, 25-35, 60-240 and 280-300: 0-10 outside torch
    # ops, 10-12 and 14-15 in aten::copy_, 12-14 in its cudaMemcpyAsync;
    # 25-30 outside, 30-31 in aten::mm, 31-35 in aten::addmm; 60-100 and
    # 280-300 in the syncs, 100-200 between the spans, 200-240 outside
    outside = trace.SPAN + " (host code outside torch ops)"
    assert idle == {outside: 10 + 5 + 40, "aten::copy_": 3, "cudaMemcpyAsync": 2,
                    "aten::mm": 1, "aten::addmm": 4, "cudaDeviceSynchronize": 40 + 20,
                    "(no host event)": 100}
    assert sum(idle.values()) == s["window_us"] - s["busy_us"]


def test_metrics_of_a_hand_made_trace():
    s = _summary(_hand_trace())
    assert _read("engine.host_ms_per_request", s) == pytest.approx(0.0275)
    assert _read("pipeline.torch_ops_per_frame", s) == 0.5
    assert _read("solver.gemm_pct", s) == pytest.approx(100 * 20 / 75)
    assert _read("kernels.launches_per_frame", s) == 0.5
    assert _read("device.idle_pct", s) == pytest.approx(75.0)
    assert _read("device.busy_ms_per_frame", s) == pytest.approx(75 / 4 * 1e-3)
    bound = 1e6 * 2 * 1550 * 2398 / 3.35e12  # erode3's bytes at the headline, twice
    assert _read("kernels.roofline_pct", s) == pytest.approx(100 * 2 * bound / 50)
    b = trace.breakdown(s)
    assert b["device_ops"][0][0] == "(anonymous namespace)::erode3_kernel<8>"
    assert b["device_ops"][0][1] == pytest.approx(50e-6)
    assert b["idle_gaps"][0] == ["(no host event)", pytest.approx(100e-6)]


def test_a_trace_without_device_ops_reads_nothing_for_device_shares():
    events = [e for e in _hand_trace() if e["cat"] not in trace.DEVICE_CATS]
    s = _summary(events)
    for name in ("solver.gemm_pct", "kernels.roofline_pct", "device.idle_pct",
                 "device.busy_ms_per_frame"):
        assert _read(name, s) is None


def test_recorded_headline_request():
    doc = json.loads((HERE / "fixtures" / "headline_request.json").read_text())
    s = trace.summarize(doc["traceEvents"], doc["frames"], doc["geom"], load.kernel_costs(),
                        load.peaks(), doc["launches"])
    assert s["requests"] == 1 and s["frames"] == 16
    assert s["kernels"].keys() == {"erode3", "preprocess_rhs_t", "fold_minor", "transpose_pair",
                                   "unfold_transpose", "unfold_clamp_paste"}
    assert {k: v["launches"] for k, v in s["kernels"].items()} == {
        "erode3": 16, "preprocess_rhs_t": 16, "fold_minor": 32, "transpose_pair": 48,
        "unfold_transpose": 32, "unfold_clamp_paste": 16}
    assert _read("kernels.launches_per_frame", s) == 10.0
    assert _read("pipeline.torch_ops_per_frame", s) == 33.5
    assert 85 < _read("solver.gemm_pct", s) < 90
    assert 3.0 < _read("device.busy_ms_per_frame", s) < 3.2
    assert 0 < _read("kernels.roofline_pct", s) < 100
    assert 0 < _read("device.idle_pct", s) < 100
    assert _read("engine.host_ms_per_request", s) == pytest.approx(s["host_us"][0] * 1e-3)
    assert sum(s["idle_by_host"].values()) == pytest.approx(s["window_us"] - s["busy_us"])
    for row in s["kernels"].values():
        assert row["bound_us"] <= row["us"]


# PERF.md §6's "bound ms" column (chip_smoke.py's counts on the padded
# layouts): a stage counted on its logical sizes is at most that, within
# the padding's share.
PERF_BOUND_MS = {
    ("erode3", "dst_pair"): (0.00222, 1), ("preprocess_rhs_t", "dst_pair"): (0.02226, 1),
    ("fold_minor", "dst_pair"): ((0.02910 + 0.03181) / 2, 2),
    ("transpose_pair", "dst_pair"): ((0.03122 + 2 * 0.01644) / 3, 3),
    ("unfold_transpose", "dst_pair"): (0.01473, 1), ("unfold_clamp_paste", "dst_pair"): (0.01661, 1),
    ("erode3", "mg_q"): (0.00635, 1), ("preprocess_rhs_q", "mg_q"): (0.06097, 1),
    ("mg_down_q", "mg_q"): (0.12589, 1), ("mg_ud_q", "mg_q"): (0.14526, 1),
    ("mg_prolong_tq", "mg_q"): (0.02905, 1), ("clamp_cast_paste_q", "mg_q"): (0.04758, 1),
    ("mg_down_t", "mg_q"): ((0.02218 + 0.00634 + 0.00164) / 3, 3),
    ("mg_up_t", "mg_q"): ((0.03142 + 0.00904 + 0.00226) / 3, 3),
}


@pytest.mark.parametrize("kernel,path", sorted(PERF_BOUND_MS))
def test_kernel_bounds_against_the_kernel_table(kernel, path):
    geom = HEADLINE if path == "dst_pair" else PANO8K
    perf_ms, launches = PERF_BOUND_MS[(kernel, path)]
    costs = load.kernel_costs()
    ops, nbytes = costs[kernel].cost(geom, launches)
    peaks = load.peaks()
    ms = 1e3 * max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks["fp32_flops_per_s"]) / launches
    # the DST kernels work on 128-padded slabs (1664 x 2432 for 1548 x 2396);
    # unfold_transpose's row in the table is one of its two launches at the
    # full grid's count; mg_down_t's level-0 row counts a given guess
    assert 0.5 * perf_ms <= ms <= 1.02 * perf_ms, (kernel, ms, perf_ms)


def test_kernel_files_without_a_count_for_another_path():
    costs = load.kernel_costs()
    for name in ("preprocess_rhs_t", "fold_minor", "transpose_pair", "unfold_transpose",
                 "unfold_clamp_paste"):
        assert costs[name].cost(PANO8K, 4) is None
    for name in ("preprocess_rhs_q", "mg_down_q", "mg_ud_q", "mg_prolong_tq", "mg_down_t",
                 "mg_up_t", "clamp_cast_paste_q"):
        assert costs[name].cost(HEADLINE, 4) is None


@pytest.mark.parametrize("hw", [(2798, 3798), (1548, 2396), (1399, 2199), (700, 900)])
def test_level_rule_is_the_multigrids(hw):
    from seamlesscloneoptimization_tpu_torch.solvers.multigrid import q_coarse_levels

    want = [(h, w) for h, w, *_ in q_coarse_levels(*hw)]
    assert geometry.mg_q_coarse_levels(*hw) == want


# -- a kernel belongs to the first cost file that counts the cell's geometry


def _cost_file(names, paths, bytes_per_launch=3.35e6):
    """A cost file whose count exists on ``paths`` alone (1 us a launch)."""
    def cost(geom, launches):
        return None if geom["path"] not in paths else (0.0, launches * bytes_per_launch)
    return SimpleNamespace(NAMES=names, cost=cost)


ERODE = "(anonymous namespace)::erode3_kernel<8>"


@pytest.mark.parametrize("path,owner,bound_us", [
    ("dst_pair", "a_first", 4.0),  # both count it: the first in name order
    ("batch", "b_second", 4.0),  # the first has no count here
    ("mg_q", "a_first", None),  # neither counts it: the first, without a bound
])
def test_a_kernel_goes_to_the_first_file_that_counts_the_geometry(path, owner, bound_us):
    costs = {"b_second": _cost_file([r"\berode3_kernel\b"], ("dst_pair", "batch")),
             "a_first": _cost_file([r"\berode3_kernel\b"], ("dst_pair",))}
    ops = {ERODE: [10.0, 4, "kernel"], "other_kernel": [2.0, 1, "kernel"]}
    table, unmatched = trace.kernel_table(ops, costs, {"path": path}, load.peaks())
    want = None if bound_us is None else pytest.approx(bound_us)
    assert table == {owner: {"us": 10.0, "launches": 4, "bound_us": want}}
    assert unmatched == {"other_kernel": 2.0}


def test_a_new_cost_file_takes_an_existing_kernel_on_its_own_path_alone():
    """A later file for ``transpose_pair`` on a path of its own, beside the
    repo's: the headline keeps every kernel where it was; on the new path
    the new file owns the kernel and gives it a bound."""
    doc = json.loads((HERE / "fixtures" / "headline_request.json").read_text())
    s = trace.summarize(doc["traceEvents"], doc["frames"], doc["geom"], load.kernel_costs(),
                        load.peaks(), doc["launches"])
    new = {**load.kernel_costs(),
           "zz_transpose_pair_batch": _cost_file([r"\btranspose_pair_(kernel|ragged)\b"],
                                                 ("batch",))}
    again = trace.summarize(doc["traceEvents"], doc["frames"], doc["geom"], new, load.peaks(),
                            doc["launches"])
    assert again["kernels"] == s["kernels"]
    ops = {n: [us, k, "kernel"] for n, (us, k) in s["device_ops"].items()}
    table, _ = trace.kernel_table(ops, new, {**doc["geom"], "path": "batch"}, load.peaks())
    assert table["zz_transpose_pair_batch"]["launches"] == 48
    assert table["zz_transpose_pair_batch"]["bound_us"] == pytest.approx(48.0)
    assert "transpose_pair" not in table and table["erode3"]["bound_us"] is not None
    assert table["fold_minor"]["bound_us"] is None  # the DST files count dst_pair alone


def _cell_geometries() -> dict:
    """Each cell's sizes as its driver takes them (every driver's geometry is
    the serve driver's: the mask's bbox centred in the destination)."""
    from portbench.drivers import serve
    from portbench.inputs import make_mask

    out = {}
    for w in load.benchmark()["workloads"]:
        cfg, spec = load.config(w["config"]), load.traffic(w["traffic"])
        out[w["name"]] = serve.geometry(cfg, make_mask(spec["mask"], cfg["src_hw"], 0))
    return out


KERNEL_NAMES = json.loads((HERE / "fixtures" / "kernel_names.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in load.benchmark()["workloads"]])
def test_no_two_cost_files_count_one_kernel_at_a_cells_geometry(cell):
    """Every device kernel name recorded in the cells' traced runs on the
    card: at each cell's geometry at most one cost file both matches it and
    counts it, so name order never decides between two counts."""
    geom = _cell_geometries()[cell]
    costs = load.kernel_costs()
    counting = {k: [re.compile(p) for p in m.NAMES] for k, m in costs.items()
                if m.cost(geom, 1) is not None}
    names = sorted({n for names in KERNEL_NAMES["cells"].values() for n in names})
    assert len(names) >= 20
    for name in names:
        owners = [k for k, pats in counting.items() if any(p.search(name) for p in pats)]
        assert len(owners) <= 1, (name, owners)
    # and each cell's own port kernels all find a counting file
    own = [n for n in KERNEL_NAMES["cells"].get(cell, []) if not trace.GEMM.search(n)
           and any(p.search(n) for m in costs.values() for p in map(re.compile, m.NAMES))]
    for name in own:
        assert any(p.search(name) for pats in counting.values() for p in pats), name
