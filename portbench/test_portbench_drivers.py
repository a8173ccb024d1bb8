"""The drivers on the CPU at a tiny geometry: the serve driver replays, bit
for bit, the loop the harness ran before drivers existed (kept here as the
oracle); the run driver sends call k of a request on pool pair p into pair
(p + k) % pool's destination and matches the float64 one-frame reference;
a traffic file with a driver other than serve is refused by a harness that
reads ``block``."""

import weakref

import numpy as np
import pytest
import torch

from portbench import harness, load, reference
from portbench.inputs import make_mask, make_pool
from portbench.traffic import Request, Reservoir, Traffic

torch.set_num_threads(1)

SEED = 2**31 + 91
TINY = {"src_hw": [40, 52], "dst_hw": [80, 100]}
CELLS = [w["name"] for w in load.benchmark()["workloads"]]
SERVE_CELLS = [c for c in CELLS
               if Traffic(load.traffic(load.cell(c)["traffic"]), 0).driver == "serve"]


def _cfg(cell):
    cfg = dict(load.config(load.cell(cell)["config"]), **TINY)
    if cfg["path"] == "mg_q":  # the tiny grid is under the crossover
        cfg["clone_config"] = {"solver": "multigrid"}
    return cfg


def _spec(cell, **kw):
    return dict(load.traffic(load.cell(cell)["traffic"]), **{"sample": 3, **kw})


# -- the oracle: the harness's serve path as it was before drivers ----------


def _old_center_of(cfg):
    if cfg["center"] == "middle":
        return cfg["dst_hw"][1] // 2, cfg["dst_hw"][0] // 2
    return tuple(cfg["center"])


def _old_geometry(cfg, mask):
    _, (x0, y0, bw, bh) = reference.prep_mask(torch.from_numpy(mask))
    left, top = reference.roi_placement((x0, y0, bw, bh), cfg["dst_hw"], _old_center_of(cfg))
    return {"c": 3, "bh": bh, "bw": bw, "h": bh - 2, "w": bw - 2, "path": cfg["path"],
            "left": left, "top": top}


def _old_call(engine, pool, mask, center, req):
    src, dst = pool[req.pair]
    out, _ = engine.timed_serve(src, dst, mask, center, loops=req.frames - 1, flags=req.flags)
    return out


def _old_compare(out, ref, geom):
    d = (out.to(ref.device).short() - ref.short()).abs()
    t, l, h, w = geom["top"] + 1, geom["left"] + 1, geom["h"], geom["w"]
    inner = d[t:t + h, l:l + w].double()
    return {"max_abs_diff": int(d.max()), "mean_abs_diff": float(inner.mean()),
            "pct_off_by_2": float((inner > 1).double().mean()) * 100.0}


def _old_references(pool, mask, center, samples):
    solver = reference.DstSolver("float64", torch.device("cpu"))
    mask_d = torch.from_numpy(mask)
    return [reference.serve_request(*pool[req.pair], mask_d, center, req.flags, req.frames,
                                    solver) for req, _ in samples]


@pytest.mark.parametrize("cell_name", SERVE_CELLS)
def test_serve_driver_replays_the_old_loop_bit_for_bit(cell_name):
    """A short window through ``drivers/serve.py``, then the sampled requests
    replayed by the old loop on a fresh engine: the same inputs and sizes,
    bit-equal outputs, the same compared numbers and megapixels."""
    from seamlesscloneoptimization_tpu_torch.core.config import CloneConfig
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

    cfg, spec = _cfg(cell_name), _spec(cell_name)
    cell = harness.prepare(cell_name, SEED, "cpu", cfg, spec)
    assert cell.driver is load.driver("serve")
    sampler = Reservoir(cell.traffic.sample, SEED)
    window = harness.serve(cell, 0.3, sampler)
    rows = harness.judge(cell, [o for _, o in sampler.items],
                         harness.references(cell, sampler.items))

    tr = Traffic(spec, SEED)
    pool = make_pool(SEED, tr.pool, cfg["src_hw"], cfg["dst_hw"], torch.device("cpu"))
    mask = make_mask(spec["mask"], cfg["src_hw"], SEED)
    center = _old_center_of(cfg)
    assert all(torch.equal(a, b) for pa, pb in zip(pool, cell.pool) for a, b in zip(pa, pb))
    assert np.array_equal(mask, cell.mask) and center == cell.center
    assert _old_geometry(cfg, mask) == cell.geom
    assert window["mpix"] == window["frames"] * cell.geom["h"] * cell.geom["w"] * 1e-6
    engine = SeamlessClone(CloneConfig(**cfg["clone_config"]), device="cpu")
    for flags, frames in tr.kinds:
        _old_call(engine, pool, mask, center, Request(-1, 0, flags, frames))
    old = [_old_call(engine, pool, mask, center, req) for req, _ in sampler.items]
    assert all(torch.equal(a, b) for a, (_, b) in zip(old, sampler.items))
    refs = _old_references(pool, mask, center, sampler.items)
    assert [_old_compare(o, r, cell.geom) for o, r in zip(old, refs)] == rows


@pytest.mark.parametrize("pair", [0, 3])
def test_run_driver_sends_frame_k_into_pool_pair_p_plus_k(pair):
    """Call k of a request on pair p composites p's patch into pair
    (p + k) % pool's destination, leaves the pool as it was, and every frame
    is within one level of the float64 reference of that one frame."""
    cell = harness.prepare("headline-run", SEED, "cpu", _cfg("headline-run"),
                           _spec("headline-run"))
    assert cell.driver is load.driver("run")
    n = len(cell.pool)
    before = [d.clone() for _, d in cell.pool]
    req = Request(0, pair, 1, n + 2)
    outs, _ = cell.call(req)
    assert len(outs) == req.frames
    assert all(torch.equal(a, d) for a, (_, d) in zip(before, cell.pool))
    g = cell.geom
    outside = torch.ones(outs[0].shape[:2], dtype=torch.bool)
    outside[g["top"] + 1:g["top"] + 1 + g["h"], g["left"] + 1:g["left"] + 1 + g["w"]] = False
    solver = reference.DstSolver("float64", torch.device("cpu"))
    mask = torch.from_numpy(cell.mask)
    src = cell.pool[pair][0]
    for k, out in enumerate(outs):
        dst = cell.pool[(pair + k) % n][1]
        assert torch.equal(out[outside], dst[outside])
        assert not any(torch.equal(out[outside], d[outside]) for j, (_, d) in enumerate(cell.pool)
                       if j != (pair + k) % n)
        ref = reference.serve_request(src, dst, mask, cell.center, 1, 1, solver)
        assert cell.driver.compare([out], [ref], g)["max_abs_diff"] <= 1
    refs = cell.driver.reference(cell, req, solver)
    assert cell.driver.compare(outs, refs, g)["max_abs_diff"] <= 1


def test_run_compare_reads_the_worst_frame():
    """One frame off reads as the request's number."""
    cell = harness.prepare("headline-run", SEED, "cpu", _cfg("headline-run"),
                           _spec("headline-run"))
    req = Request(0, 1, 1, 3)
    outs, _ = cell.call(req)
    refs = cell.driver.reference(cell, req, reference.DstSolver("float64", torch.device("cpu")))
    g = cell.geom
    bad = [o.clone() for o in outs]
    bad[1][g["top"] + 1, g["left"] + 1] += 9
    worst = cell.driver.compare(bad, refs, g)
    assert worst["max_abs_diff"] >= 8 > cell.driver.compare(outs, refs, g)["max_abs_diff"]
    with pytest.raises(ValueError):
        cell.driver.compare(outs[:2], refs, g)


def test_a_driver_traffic_file_is_refused_by_a_harness_that_reads_block():
    """``run16`` lists its kinds under ``request_kinds``: a harness from
    before drivers (``spec["block"]``) stops in its set-up; this one refuses
    a driver's kinds under ``block`` and a file with both keys or neither."""
    spec = load.traffic("run16")
    assert spec["driver"] == "run" and "block" not in spec
    with pytest.raises(KeyError):
        spec["block"]  # what the harness before drivers read first
    assert Traffic(spec, SEED).block == [(1, 16)]
    kinds = spec["request_kinds"]
    no_kinds = {k: v for k, v in spec.items() if k != "request_kinds"}
    for bad in ({**no_kinds, "block": kinds}, {**spec, "block": kinds}, no_kinds):
        with pytest.raises(ValueError):
            Traffic(bad, SEED)
    assert Traffic({**no_kinds, "driver": "serve", "block": kinds}, SEED).driver == "serve"


@pytest.mark.parametrize("name", ["nope", "../harness", "serve.x", ""])
def test_load_driver_refuses_what_is_not_a_driver_file(name):
    with pytest.raises(KeyError):
        load.driver(name)


def test_every_cell_loads_its_driver_by_its_traffic_file():
    got = {c: load.driver(Traffic(load.traffic(load.cell(c)["traffic"]), 0).driver).__name__
           for c in CELLS}
    assert got["headline-run"] == "portbench.drivers.run"
    assert {got[c] for c in SERVE_CELLS} == {"portbench.drivers.serve"}
    assert set(SERVE_CELLS) >= {"headline-clip16", "pano8k-clip16", "headline-modes16"}


def test_a_run_window_counts_16_frames_a_request():
    cell = harness.prepare("headline-run", SEED, "cpu", _cfg("headline-run"),
                           _spec("headline-run"))
    window = harness.serve(cell, 0.2, Reservoir(3, SEED))
    assert window["frames"] == 16 * window["attempted"] and window["failed"] == 0
    assert window["mpix"] == window["frames"] * cell.geom["h"] * cell.geom["w"] * 1e-6


def test_run_warm_up_holds_as_many_answers_as_the_window(monkeypatch):
    """The run driver's warm-up sends the sample, the last request and the
    one in flight, each of the longest kind, all held at once."""
    from seamlesscloneoptimization_tpu_torch.core.engine import SeamlessClone

    real, live, most = SeamlessClone.run, [], []

    def run(self, *a, **k):
        out = real(self, *a, **k)
        live.append(weakref.ref(out))
        most.append(sum(r() is not None for r in live))
        return out

    monkeypatch.setattr(SeamlessClone, "run", run)
    harness.prepare("headline-run", SEED, "cpu", _cfg("headline-run"), _spec("headline-run"))
    assert len(live) == (3 + 2) * 16 and max(most) == len(live)


def test_dropin_driver_calls_the_api_on_host_arrays(monkeypatch):
    """A drop-in request is one ``api.seamless_clone`` call on the host pool's
    arrays, numpy out, through the API's cached engine; the answer is one
    frame within a level of the float64 reference; ``destroy`` empties the
    API's engine cache; a setting the API cannot take is refused."""
    from seamlesscloneoptimization_tpu_torch import api

    cell = harness.prepare("headline-dropin", SEED, "cpu", _cfg("headline-dropin"),
                           _spec("headline-dropin"))
    assert cell.driver is load.driver("dropin")
    assert all(isinstance(a, np.ndarray) for pair in cell.pool for a in pair)
    seen = []
    real = api.seamless_clone
    monkeypatch.setattr(api, "seamless_clone",
                        lambda *a, **k: seen.append((a, k)) or real(*a, **k))
    req = Request(0, 2, 1, 1)
    out, dt = cell.call(req)
    assert isinstance(out, np.ndarray) and out.shape == (*TINY["dst_hw"], 3) and dt > 0
    (src, dst, mask, center, flags), kw = seen[0]
    assert src is cell.pool[2][0] and dst is cell.pool[2][1] and mask is cell.mask
    assert (center, flags) == (cell.center, 1) and kw["solver"] == "auto"
    assert len(api._engines) == 1 and cell.engine.metrics.get("bbox") is not None
    assert cell.engine.device_memory_bytes() > 0
    ref = cell.driver.reference(cell, req, reference.DstSolver("float64", torch.device("cpu")))
    assert cell.driver.compare(out, ref, cell.geom)["max_abs_diff"] <= 1
    g = cell.geom
    outside = np.ones(out.shape[:2], bool)
    outside[g["top"] + 1:g["top"] + 1 + g["h"], g["left"] + 1:g["left"] + 1 + g["w"]] = False
    assert np.array_equal(out[outside], cell.pool[2][1][outside])
    cell.engine.destroy()
    assert len(api._engines) == 0 and cell.engine.device_memory_bytes() == 0
    with pytest.raises(ValueError):
        cell.driver.engine({"precision": "default"}, cell.device)
    with pytest.raises(ValueError):
        cell.call(Request(0, 0, 1, 2))
