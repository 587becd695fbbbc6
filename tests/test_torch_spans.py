"""The port's host spans (``lshm_tpu_torch/utils/spans.py``): nothing without a
profiler; under a CPU profiler of the user scope on every thread, ``Trainer.run``
records each ``trainer.*`` span once a minibatch and each ``admm.*`` span once an ADMM
iteration inside ``trainer.step``, unfused and fused, with and without the prefetch
thread, whose ``prefetch.*`` spans lie on a thread of their own; and a span open
across a session's start, its stop, or its stop and the next session's start neither
raises nor spoils what the sessions record."""

import contextlib
from collections import Counter

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
from torch._C._profiler import ProfilerActivity, RecordScope, _ExperimentalConfig

from lshm_tpu_torch import config as tc
from lshm_tpu_torch.data import MinibatchSampler, synth_extract
from lshm_tpu_torch.train import Trainer
from lshm_tpu_torch.train.step import make_train_step
from lshm_tpu_torch.utils import MetricLogger
from lshm_tpu_torch.utils import spans
from lshm_tpu_torch.utils.spans import span

TREE = synth_extract(nstations=4, ntime=192, nfreq=192, seed=7)
ADMM = 2
MINIBATCHES = 2
LOOP = ("trainer.fetch", "trainer.prepare", "trainer.settle", "trainer.log",
        "trainer.snapshot", "trainer.step")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def user_ranges():
    """A CPU profiler session that records host ranges of the user scope only, on every
    thread, with the flag a ``torch.profiler`` session sets; yields a list filled at
    the stop with (name, thread, start_ns, end_ns, ended before the stop)."""
    cfg = autograd_profiler.profile(
        experimental_config=_ExperimentalConfig(profile_all_threads=True)).config()
    acts = {ProfilerActivity.CPU}
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    autograd_profiler._run_on_profiler_start()
    out: list = []
    try:
        yield out
    finally:
        result = _disable_profiler()
        autograd_profiler._run_on_profiler_stop()
    out.extend((e.name(), e.device_resource_id(), e.start_ns(), e.end_ns(),
                e.end_thread_id() == e.start_thread_id())
               for e in result.events() if e.is_user_annotation())


def tiny_cfg(prefetch: int) -> tc.Config:
    return tc.Config(
        data=tc.DataConfig(batch_size=1, patch_size=128, num_channels=4, prefetch=prefetch),
        model=tc.ModelConfig(latent_dim=16, latent_dim_1d=8, num_clusters=4, rica=True),
        train=tc.TrainConfig(num_epochs=1, iters_per_epoch=MINIBATCHES, admm_iters=ADMM,
                             checkpoint_dir=""),
    )


def _trainer(cfg, fused: bool) -> Trainer:
    t = Trainer(cfg, device="cpu", logger=MetricLogger(echo=False))
    if fused:     # the Trainer builds the unfused step; the fused one in its place
        t._step = lambda kind, group, n: make_train_step(cfg, n, fused=True)
    return t


def test_without_a_profiler_a_span_is_the_shared_no_op(monkeypatch):
    opened, real = [], autograd_profiler.record_function

    def record_function(name, args=None):
        opened.append(name)
        return real(name, args)

    monkeypatch.setattr(autograd_profiler, "record_function", record_function)
    assert not autograd_profiler._is_profiler_enabled
    assert span("trainer.step") is span("admm.forward")
    with span("trainer.step"):
        pass
    cfg = tiny_cfg(prefetch=2)
    _trainer(cfg, fused=False).run(MinibatchSampler([TREE], ["0"], cfg.data, seed=0))
    assert [n for n in opened if not n.startswith("Optimizer.")] == []


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("fused", [False, True])
def test_trainer_spans(fused, prefetch):
    cfg = tiny_cfg(prefetch)
    trainer = _trainer(cfg, fused)
    sampler = MinibatchSampler([TREE], ["0"], cfg.data, seed=0)
    with user_ranges() as ranges:
        trainer.run(sampler)
    assert all(done for *_, done in ranges)
    steps = [r for r in ranges if r[0] == "trainer.step"]
    assert len(steps) == MINIBATCHES
    launcher = steps[0][1]
    own = Counter(n for n, th, *_ in ranges if th == launcher and n.startswith(("trainer.",
                                                                                "admm.")))
    expected = {n: MINIBATCHES for n in LOOP}
    expected.update({f"admm.{n}": ADMM * MINIBATCHES
                     for n in ("forward", "backward", "optimizer")})
    if not fused:
        expected["admm.dual"] = ADMM * MINIBATCHES
    assert own == expected
    for name, th, s, e, _ in ranges:
        if name.startswith("admm."):
            assert th == launcher
            assert sum(s0 <= s and e <= e0 for _, _, s0, e0, _ in steps) == 1, name
    prefetched = [r for r in ranges if r[0].startswith("prefetch.")]
    if prefetch:
        assert {n for n, *_ in prefetched} == {"prefetch.sample", "prefetch.stage"}
        assert {th for _, th, *_ in prefetched} != {launcher}
        assert launcher not in {th for _, th, *_ in prefetched}
    else:
        assert prefetched == []


@pytest.mark.parametrize("across", ["start", "stop", "stop_then_start"])
def test_a_span_open_across_the_start_or_the_stop(across):
    def session():
        with user_ranges() as ranges:
            with span("admm.forward"):
                pass
        return ranges

    if across == "start":
        with span("trainer.step"):           # opened before the session: not recorded
            ranges = session()
        assert [r[0] for r in ranges] == ["admm.forward"]
    else:
        with user_ranges() as ranges:
            outer = span("trainer.step")
            outer.__enter__()
            with span("admm.forward"):
                pass
        crossed = len(spans._crossed)
        if across == "stop":
            outer.__exit__(None, None, None)     # after the stop: neither raises nor records
            assert len(spans._crossed) == crossed
        else:
            # ended under the next session it would write into the first one's freed
            # events: it is kept, unended, and the next session records none of it
            with user_ranges() as later:
                outer.__exit__(None, None, None)
                with span("admm.backward"):
                    pass
            assert len(spans._crossed) == crossed + 1
            assert [(r[0], r[4]) for r in later] == [("admm.backward", True)]
        named = {r[0]: r for r in ranges}
        assert set(named) == {"trainer.step", "admm.forward"}
        assert named["admm.forward"][4] and not named["trainer.step"][4]
        assert named["trainer.step"][2] <= named["admm.forward"][2]
    assert not autograd_profiler._is_profiler_enabled
    again = session()                          # the next session is whole
    assert [(r[0], r[4]) for r in again] == [("admm.forward", True)]

