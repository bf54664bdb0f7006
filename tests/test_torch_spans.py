"""The port's span recorder (``probunet_tpu_torch.utils.profiling.span``)
and the spans the program opens at its layer boundaries, on the CPU:

- off by default: a span records nothing and is the shared no-op context;
- on after ``enable(True)``, and inside a ``torch.profiler`` session of
  CPU activities only, off again after it;
- each span's parent and thread; the buffer keeps the last ``MAX_SPANS``;
- a tiny training step records its forward, backward and optimizer once
  each, and gives bit-identical outputs with tracing on and off;
- ``sample``, ``EvalAccumulator.update``, ``get_hr_batch`` through
  ``prefetch_to_device``, and the pinned slot's fill record theirs.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest
import torch

from probunet_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def fresh_recorder():
    """Tracing off and no span recorded, before and after each test."""
    was = profiling._on
    profiling.enable(False)
    profiling.clear()
    yield
    profiling.enable(was)
    profiling.clear()


def _names() -> list[str]:
    return [s.name for s in profiling.spans()]


def test_off_by_default_records_nothing():
    ctx = profiling.span("x.off")
    assert ctx is profiling.span("x.other") is profiling._OFF
    with ctx:
        pass
    assert profiling.spans() == []


def test_on_by_enable_and_inside_a_profiler_session():
    profiling.enable(True)
    with profiling.span("x.enabled"):
        pass
    profiling.enable(False)
    with profiling.span("x.after_disable"):
        pass
    assert _names() == ["x.enabled"]
    profiling.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.profiler_active()
        with profiling.span("x.profiled"):
            torch.ones(2).add_(1)
    assert not profiling.profiler_active()
    with profiling.span("x.after_profiler"):
        pass
    assert _names() == ["x.profiled"]
    s = profiling.spans()[0]
    assert s.end >= s.start > 0


def test_parents_threads_and_a_bounded_buffer():
    profiling.enable(True)
    with profiling.span("outer.a"):
        with profiling.span("inner.b"):
            pass
        with profiling.span("inner.d"):
            t = threading.Thread(target=_closed_span)
            t.start()
            t.join(timeout=10)
            assert not t.is_alive()
    by = {s.name: s for s in profiling.spans()}
    outer = by["outer.a"]
    assert outer.parent is None
    assert by["inner.b"].parent == outer.id and by["inner.d"].parent == outer.id
    assert by["thread.c"].parent is None
    assert by["thread.c"].thread != outer.thread == threading.get_ident()
    assert outer.start <= by["inner.b"].start <= by["inner.b"].end <= by["inner.d"].start
    profiling.clear()
    for _ in range(profiling.MAX_SPANS + 5):
        with profiling.span("x.many"):
            pass
    kept = profiling.spans()
    assert len(kept) == profiling.MAX_SPANS
    assert kept[0].id == kept[-1].id - profiling.MAX_SPANS + 1


def _closed_span():
    with profiling.span("thread.c"):
        pass


def _tiny_cfg():
    from probunet_tpu_torch.config import preset

    cfg = preset("probunet_multivar_128")
    m = cfg.model
    m.latent_dim, m.num_filters, m.model_channels = 4, (8, 16), 8
    m.channel_mult, m.num_blocks, m.compute_dtype = (1, 2), 1, "float32"
    cfg.data.resolution, cfg.data.lowres_scale = (16, 16), 4
    cfg.train.batch_size, cfg.train.ensemble_size = 2, 3
    return cfg


def _tiny_data(cfg, days: int = 6):
    from probunet_tpu_torch.data.climex import ClimexDataset
    from probunet_tpu_torch.data.synthetic import synthetic_climex_fields

    d = cfg.data
    phys = synthetic_climex_fields(days, *d.resolution, seed=3)
    return ClimexDataset(hr=phys, variables=d.variables, pipeline=d.pipeline,
                         lowres_scale=d.lowres_scale, transfo=d.transfo, device="cpu")


def _tiny_model(cfg):
    from probunet_tpu_torch.models.prob_unet import ProbabilisticUNet

    return ProbabilisticUNet.from_config(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_train_step_records_its_three_phases_and_is_unchanged():
    from probunet_tpu_torch.train.loop import make_train_step
    from probunet_tpu_torch.train.state import create_train_state

    cfg = _tiny_cfg()
    ds = _tiny_data(cfg)
    stats = ds.device_stats("cpu")
    hr = torch.from_numpy(ds.get_hr_batch(np.arange(2)))
    outs = []
    for on in (False, True):
        profiling.enable(on)
        profiling.clear()
        model = _tiny_model(cfg)
        state = create_train_state(model, seed=1, lr=1e-3, device="cpu")
        state, out = make_train_step(model, cfg)(state, hr, stats, 1.0, 0.01)
        outs.append((out, [p.detach().clone() for p in model.parameters()], _names()))
    (off, p_off, n_off), (on, p_on, n_on) = outs
    assert n_off == []
    assert n_on == ["train.forward", "train.backward", "train.optimizer"]
    assert off.keys() == on.keys()
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert all(torch.equal(a, b) for a, b in zip(p_off, p_on))


def test_sample_update_gather_and_pin_record_their_spans():
    from probunet_tpu_torch.data.loader import Batches, _PinnedSlot, prefetch_to_device
    from probunet_tpu_torch.evals import EvalAccumulator

    cfg = _tiny_cfg()
    ds = _tiny_data(cfg)
    model = _tiny_model(cfg).eval()
    profiling.enable(True)
    feed = prefetch_to_device((ds.get_hr_batch(i) for i in Batches(len(ds), 2)),
                              device="cpu")
    hrs = list(feed)
    assert len(hrs) == 3 and _names() == ["data.gather"] * 3
    profiling.clear()
    batch = ds.preprocess(hrs[0])
    with torch.inference_mode():
        ens = model.sample(batch["inputs"], 3, generator=torch.Generator().manual_seed(2))
        EvalAccumulator().update(ens, batch["targets"])
    assert _names() == ["serve.sample", "evals.read"]
    profiling.clear()
    slot = _PinnedSlot()
    slot.buf = torch.empty(hrs[0].shape)     # no pinned allocator on the CPU
    assert torch.equal(slot.fill(hrs[0]), hrs[0])
    assert _names() == ["data.pin"]
