"""The span recorder (``rpnet_tpu_torch/utils/profiling.py``) and the spans
the program opens, on the CPU at tiny shapes:

  * nesting, parent and unit ids across threads (a prefetch worker's
    ``sample`` is a unit of its own), and the ring's bound;
  * the spans' clock is the profiler's: a span holds the profiler's events
    of the operators it ran;
  * no CUDA event pair without a profiler, and none on the CPU;
  * an eval pass records, per episode, ``registration`` and ``network``
    under ``dispatch`` with one unit id, its ``stage_timing`` line as
    before; the train step records ``registration`` inside ``train.step``;
    the LGCA whole-volume eval records ``lgca.fetch``, ``lgca.dice`` and one
    ``lgca.context`` a chunk (and shard, over a mesh) under ``lgca.volume``;
  * ``torch.export`` of the episode program takes no span, and the saved
    program still matches the live episode function.
"""

import contextlib
import io
import re
import threading

import numpy as np
import pytest
import torch

from rpnet_tpu_torch.utils import profiling
from rpnet_tpu_torch.utils.profiling import SPANS, span

torch.set_num_threads(2)   # small shapes; the suite runs several workers on one machine


def _since(mark: int):
    """The records closed after the record ``mark`` (an id), in id order."""
    return sorted((r for r in list(SPANS) if r.id > mark), key=lambda r: r.id)


def _mark() -> int:
    with span("mark"):
        pass
    return SPANS[-1].id


def test_spans_nest_per_thread():
    mark = _mark()
    seen = {}

    def worker():
        with span("outer"):
            with span("inner"):
                seen["thread"] = threading.get_ident()

    with span("outer"):
        with span("mid"):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=10)
            with span("inner"):
                pass
    assert not t.is_alive()
    recs = {(r.name, r.thread): r for r in _since(mark)}
    main = threading.get_ident()
    outer, mid, inner = (recs[(n, main)] for n in ("outer", "mid", "inner"))
    assert (outer.parent, mid.parent, inner.parent) == (None, outer.id, mid.id)
    assert outer.unit == mid.unit == inner.unit == outer.id
    w_outer, w_inner = recs[("outer", seen["thread"])], recs[("inner", seen["thread"])]
    assert w_outer.parent is None and w_inner.parent == w_outer.id
    assert w_outer.unit == w_inner.unit == w_outer.id != outer.unit
    assert (outer.start_ns <= mid.start_ns <= inner.start_ns <= inner.end_ns <= mid.end_ns
            <= outer.end_ns)


def test_a_decorated_function_opens_a_span_a_call():
    @span("call")
    def f(n):
        if n:
            f(n - 1)

    mark = _mark()
    f(2)
    recs = [r for r in _since(mark) if r.name == "call"]
    assert len(recs) == 3 and len({r.id for r in recs}) == 3
    top = next(r for r in recs if r.parent is None)
    assert all(r.unit == top.unit for r in recs)


def test_the_ring_is_bounded():
    assert SPANS.maxlen == profiling.SPANS_KEPT
    for _ in range(profiling.SPANS_KEPT + 5):
        with span("fill"):
            pass
    assert len(SPANS) == profiling.SPANS_KEPT
    assert SPANS[-1].name == "fill" and SPANS[-1].id - SPANS[0].id == profiling.SPANS_KEPT - 1


def test_a_span_holds_the_profilers_events_of_its_work():
    """Under a CPU profiler, the profiler's events of the operators a span
    ran lie inside the span, to the millisecond: one clock."""
    from torch.profiler import ProfilerActivity, profile

    a = torch.randn(128, 128)
    mark = _mark()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("work", torch.device("cpu")):
            for _ in range(3):
                a = torch.mm(a, a).tanh()
    rec = next(r for r in _since(mark) if r.name == "work")
    assert rec.events is None and rec.device_ms() is None   # no pair on the CPU
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name() in ("aten::mm", "aten::tanh")]
    assert len(ops) == 6
    ms = 1_000_000
    assert all(rec.start_ns - ms <= s and e <= rec.end_ns + ms for s, e in ops)


def test_no_device_pair_without_a_profiler():
    mark = _mark()
    with span("quiet", torch.device("cuda")):   # no profiler: nothing touches CUDA
        pass
    rec = _since(mark)[-1]
    assert rec.name == "quiet" and rec.events is None and rec.device_ms() is None


# ---------------------------------------------------------------- eval pass

@pytest.fixture(scope="module")
def eval_config(tmp_path_factory):
    from rpnet_tpu_torch.config import Config
    from rpnet_tpu_torch.core.synthetic import generate_dataset

    paths = generate_dataset(str(tmp_path_factory.mktemp("spans") / "data"), n_train=1,
                             n_test=2, shape=(16, 48, 48), seed=0)
    return Config(dict(data_dir=paths["data_dir"], class_csv_dir=paths["class_dir"],
                       eval_set_name=paths["test_csv"], num_slice=16, num_x=48, num_y=48,
                       crop_size=[32, 32], k=2, eval_classes=["Liver"], n_iter_refinement=1,
                       n_test_iter_refinement=1, mask_refinement_correlation_radius=1,
                       reg_affine_iters=2, n_runs=1, seed=0, use_native_io=False))


def test_eval_pass_spans_each_episode(eval_config):
    from rpnet_tpu_torch.cli.test_rpnet import build_runner, evaluate
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler

    sampler = EpisodeSampler(eval_config["data_dir"], eval_config["eval_set_name"], eval_config)
    runner = build_runner(eval_config, torch.device("cpu"))
    mark = _mark()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        failures = evaluate(runner, sampler, eval_config)[3]
    n = len(sampler)
    assert failures == 0 and n == 2
    recs = _since(mark)
    dispatch = [r for r in recs if r.name == "dispatch"]
    assert len(dispatch) == n and all(r.parent is None for r in dispatch)
    for d in dispatch:
        kids = [r for r in recs if r.unit == d.id and r is not d]
        assert sorted(r.name for r in kids) == ["network", "registration"]
        assert all(r.parent == d.id and r.events is None for r in kids)
    for name in ("data", "episode_compute"):
        assert sum(r.name == name and r.parent is None for r in recs) == n
    line = [l for l in out.getvalue().splitlines() if l.startswith("stage_timing ")]
    assert len(line) == 1
    stages = re.fullmatch(r"stage_timing((?: \w+=\d+\.\d{3}s/\d+x)+)", line[0]).group(1)
    assert sorted(s.split("=")[0] for s in stages.split()) == ["data", "dispatch",
                                                               "episode_compute"]
    assert all(s.endswith(f"/{n}x") for s in stages.split())


def test_prefetch_workers_sample_in_units_of_their_own(eval_config):
    from rpnet_tpu_torch.episode.prefetch import PrefetchingSampler
    from rpnet_tpu_torch.episode.sampler import EpisodeSampler

    sampler = EpisodeSampler(eval_config["data_dir"], eval_config["eval_set_name"], eval_config)
    mark = _mark()
    with span("pass"):
        episodes = list(PrefetchingSampler(sampler, lookahead=2, workers=2))
    assert len(episodes) == len(sampler)
    recs = _since(mark)
    top = next(r for r in recs if r.name == "pass")
    samples = [r for r in recs if r.name == "sample"]
    assert len(samples) == len(sampler)
    assert all(r.parent is None and r.unit == r.id and r.thread != top.thread for r in samples)


# ---------------------------------------------------------------- training

def test_train_step_spans_registration_inside_the_step():
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.train.trainer import make_optimizer, make_train_step

    cfg = dict(n_way=1, n_shot=1, k=2, crop_size=[32, 32], n_iter_refinement=1,
               mask_refinement_correlation_radius=1, reg_affine_iters=2, reg_fit_scale=1,
               scheduler_step=0, backbone="UNet")
    model = build_rpnet(cfg, num_iter=1, seed=0, align=True)
    step = make_train_step(model, cfg, make_optimizer(model.parameters(), cfg))
    g = torch.Generator().manual_seed(0)
    img = lambda *s: torch.rand(s, generator=g) * 2 - 1
    lab = lambda *s: (torch.rand(s, generator=g) > 0.5).float()
    mark = _mark()
    out = step({"step": 0}, (img(1, 1, 2, 32, 32), lab(1, 1, 2, 32, 32),
                             img(1, 2, 32, 32), lab(1, 2, 32, 32)))
    assert torch.isfinite(out["loss"])
    recs = _since(mark)
    steps = [r for r in recs if r.name == "train.step"]
    regs = [r for r in recs if r.name == "registration"]
    assert len(steps) == 1 and steps[0].parent is None and len(regs) == 1
    assert regs[0].parent == steps[0].id and regs[0].unit == steps[0].id


# ---------------------------------------------------------------- LGCA eval

@pytest.mark.parametrize("data", [None, 2])
def test_lgca_volume_spans_its_chunks_fetch_and_dice(data):
    from rpnet_tpu_torch.models.lgca import LGCANetV3
    from rpnet_tpu_torch.parallel.mesh import make_mesh
    from rpnet_tpu_torch.train.lgca import evaluate_lgca_volume

    torch.manual_seed(0)
    model = LGCANetV3(output_ch=2, feature_scale=8.0)
    rng = np.random.RandomState(0)
    D, H = 6, 32
    sample = {"volume": rng.randn(1, 8, H // 2, H // 2, 1).astype(np.float32),
              "slices": rng.randn(D, H, H, 1).astype(np.float32),
              "mask": (rng.rand(D, H, H, 2) > 0.6).astype(np.float32)}
    mesh = None if data is None else make_mesh({"data": data}, devices=[torch.device("cpu")] * data)
    mark = _mark()
    dice = evaluate_lgca_volume(model, sample, "cpu", chunk=4, mesh=mesh)
    assert set(dice) == {"class_0", "class_1"}
    recs = _since(mark)
    vol = [r for r in recs if r.name == "lgca.volume"]
    assert len(vol) == 1 and vol[0].parent is None
    under = [r for r in recs if r.unit == vol[0].id and r is not vol[0]]
    shards = data or 1   # each chunk's context net runs once a shard
    assert sorted(r.name for r in under) == (["lgca.context"] * 2 * shards
                                             + ["lgca.dice", "lgca.fetch"])
    assert all(r.parent == vol[0].id for r in under)
    fetch, dice_span = (next(r for r in under if r.name == n) for n in ("lgca.fetch", "lgca.dice"))
    assert max(r.end_ns for r in under if r.name == "lgca.context") <= fetch.start_ns
    assert fetch.end_ns <= dice_span.start_ns


# ---------------------------------------------------------------- export

def test_export_takes_no_span_and_still_matches_live():
    """``torch.export`` traces the episode function non-strictly: its spans
    stay closed, the program holds no profiler node, and the saved and
    reloaded program equals the live episode function."""
    from rpnet_tpu_torch.episode.pipeline import episode_metrics_fn
    from rpnet_tpu_torch.models.factory import build_rpnet
    from rpnet_tpu_torch.serve import export as se

    size, dq = 32, 2
    model = build_rpnet(dict(crop_size=[size, size], mask_refinement_correlation_radius=1,
                             backbone="UNet"), num_iter=1, seed=3)
    mark = _mark()
    exported = se.export_episode_program(model, slices=dq, height=size, width=size,
                                         affine_iters=2, fit_scale=1, device="cpu",
                                         compute_dtype=torch.float32)
    assert _since(mark) == []
    assert not [n for n in se.graph_nodes(exported)
                if "profiler" in str(n.target) or "record_function" in str(n.target)]
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        se.save_artifact(exported, d, se.weight_names(model))
        program = se.load_artifact(d, "cpu")
        g = torch.Generator().manual_seed(1)
        arrays = (torch.rand(1, dq, size, size, generator=g) * 2 - 1,
                  (torch.rand(1, dq, size, size, generator=g) > 0.5).float(),
                  torch.rand(dq, size, size, generator=g) * 2 - 1,
                  (torch.rand(dq, size, size, generator=g) > 0.5).float(), torch.ones(dq))
        sd = model.state_dict()
        out = program(tuple(sd[n].float() for n in program.manifest["weights"]), *arrays)
    net = model.eval()
    mark = _mark()
    with torch.no_grad():
        live = episode_metrics_fn(net, 2, 1, torch.float32)(*arrays)
    assert sorted(r.name for r in _since(mark)) == ["network", "registration"]
    for o, r in zip(out, live):
        torch.testing.assert_close(o, r, rtol=0, atol=1e-6)
