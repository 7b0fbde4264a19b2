"""The port's data pipeline, checkpoint store and trainer against the JAX package's.

* Data: ``SyntheticLM`` and ``MemmapDataset`` give the reference's batches
  bit for bit for one seed (``write_corpus`` the same shard bytes), across
  an epoch boundary; ``state()``/``seek()`` restart at the same place; the
  ``Prefetcher`` keeps order, passes errors on and joins its thread on
  ``close()`` or at the end of a ``with`` block, also mid-stream.
* Checkpoints: the round trip (bfloat16 kept), a partial ``.tmp``
  directory ignored, retention, async saves, and a checkpoint written by
  the reference restored by the port and the reverse.
* The trainer, on the reference's substrate cases (runs and checkpoints,
  a restart resumes, NaN steps skipped) and: persistent NaNs raise, a
  preemption saves at its step, the data state rides in the manifest,
  straggler strikes call the elastic hook (a fake clock), and the SIGTERM
  and SIGINT handlers after ``run()`` are the objects from before it.

No test here starts the reference's ``Trainer``.
"""

import signal
import threading

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jax_store
from repro.data import pipeline as jax_pipeline
from repro_torch.checkpoint import store
from repro_torch.data.pipeline import MemmapDataset, Prefetcher, SyntheticLM, write_corpus
from repro_torch.runtime import trainer as trainer_mod
from repro_torch.runtime.trainer import Trainer, TrainerConfig

SIGNALS = (signal.SIGTERM, signal.SIGINT)


def _same_batches(got, want):
    assert got.keys() == want.keys() == {"tokens", "labels"}
    for key in got:
        assert got[key].dtype == want[key].dtype == np.int32
        np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------------------ data

def test_synthetic_batches_match_jax():
    ds = SyntheticLM(vocab_size=1000, seq_len=40, batch=3, seed=7)
    ref = jax_pipeline.SyntheticLM(vocab_size=1000, seq_len=40, batch=3, seed=7)
    for i in (0, 1, 5, 123):
        _same_batches(ds.batch_at(i), ref.batch_at(i))
    it, rit = iter(ds), iter(ref)
    for _ in range(3):
        _same_batches(next(it), next(rit))
    b = ds.batch_at(5)
    assert np.array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


def test_memmap_dataset_matches_jax_and_restarts(tmp_path):
    paths = write_corpus(tmp_path / "port", n_tokens=4096, vocab_size=64, shard_tokens=1000)
    ref_paths = jax_pipeline.write_corpus(tmp_path / "ref", n_tokens=4096, vocab_size=64,
                                          shard_tokens=1000)
    assert [p.read_bytes() for p in paths] == [p.read_bytes() for p in ref_paths]
    ds = MemmapDataset(tmp_path / "port", seq_len=16, batch=4, seed=0)
    ref = jax_pipeline.MemmapDataset(tmp_path / "ref", seq_len=16, batch=4, seed=0)
    for _ in range(70):  # 240 windows: past the first epoch
        _same_batches(ds.next_batch(), ref.next_batch())
        assert ds.state() == ref.state()
    assert ds.state()["epoch"] == 1
    state = ds.state()
    b_next = ds.next_batch()
    ds2 = MemmapDataset(tmp_path / "port", seq_len=16, batch=4, seed=0)
    ds2.seek(state)
    _same_batches(ds2.next_batch(), b_next)


def test_prefetcher_preserves_order_and_joins():
    with Prefetcher(iter([{"i": i} for i in range(20)]), depth=3) as pre:
        assert [o["i"] for o in pre] == list(range(20))
    assert not pre._thread.is_alive()


def test_prefetcher_close_stops_an_endless_stream():
    pre = Prefetcher(iter(SyntheticLM(vocab_size=50, seq_len=8, batch=2)), depth=2)
    first = [next(pre) for _ in range(3)]
    assert len(first) == 3
    pre.close()
    assert not pre._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pre)


def test_prefetcher_passes_errors_on():
    def broken():
        yield {"i": 0}
        raise KeyError("lost shard")

    with Prefetcher(broken()) as pre:
        assert next(pre) == {"i": 0}
        with pytest.raises(KeyError, match="lost shard"):
            next(pre)


# ------------------------------------------------------------ checkpoint

def _tree():
    return {"a": torch.arange(10, dtype=torch.float32),
            "nested": {"b": torch.ones(3, 3, dtype=torch.bfloat16) * 1.5,
                       "step": torch.tensor(7, dtype=torch.int32)},
            "lst": [torch.zeros(2), torch.ones(2, dtype=torch.float64)]}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    store.save(tmp_path, 7, tree, extra={"data_state": {"epoch": 1, "index": 2}})
    restored, step = store.restore(tmp_path, tree)
    assert step == 7
    assert torch.equal(restored["a"], tree["a"])
    assert restored["nested"]["b"].dtype == torch.bfloat16
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    assert restored["nested"]["step"].dtype == torch.int32 and int(restored["nested"]["step"]) == 7
    assert restored["lst"][1].dtype == torch.float64
    like = {"a": torch.zeros(10, dtype=torch.bfloat16), "nested": tree["nested"],
            "lst": tree["lst"]}
    assert store.restore(tmp_path, like)[0]["a"].dtype == torch.bfloat16  # cast to the like


def test_checkpoint_atomicity_partial_write_ignored(tmp_path):
    store.save(tmp_path, 1, {"a": torch.arange(4.0)})
    (tmp_path / "step_00000002.tmp").mkdir()  # a crashed writer
    assert store.latest_step(tmp_path) == 1
    assert store.restore(tmp_path, {"a": torch.zeros(4)})[1] == 1


def test_checkpoint_retention(tmp_path):
    for s in range(5):
        store.save(tmp_path, s, {"a": torch.zeros(1)})
    store.retain(tmp_path, keep=2)
    assert store.latest_step(tmp_path) == 4
    assert not (tmp_path / "step_00000000").exists()
    assert (tmp_path / "step_00000003").exists()


def test_async_checkpointer(tmp_path):
    ck = store.AsyncCheckpointer(tmp_path, keep=2)
    w = torch.zeros(4)
    for s in range(3):
        w = w + 1.0
        ck.save(s, {"w": w})
    ck.close()
    assert not ck._thread.is_alive()
    restored, step = store.restore(tmp_path, {"w": torch.zeros(4)})
    assert step == 2
    assert torch.equal(restored["w"], torch.full((4,), 3.0))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001", "step_00000002"]


def test_checkpoints_cross_between_the_packages(tmp_path):
    """The reference's checkpoint restores in the port and the port's in
    the reference: the same keys (dict keys, ``#<i>`` list positions),
    bfloat16 as raw bits with its ``::dtype`` entry."""
    tree = _tree()
    jtree = {"a": jnp.arange(10, dtype=jnp.float32),
             "nested": {"b": jnp.ones((3, 3), jnp.bfloat16) * 1.5,
                        "step": jnp.asarray(7, jnp.int32)},
             "lst": [jnp.zeros(2), np.ones(2, np.float64)]}
    jax_store.save(tmp_path / "ref", 3, jtree)
    restored, step = store.restore(tmp_path / "ref", tree)
    assert step == 3
    for got, want in ((restored["a"], tree["a"]), (restored["nested"]["b"], tree["nested"]["b"]),
                      (restored["lst"][1], tree["lst"][1])):
        assert got.dtype == want.dtype and torch.equal(got, want)

    store.save(tmp_path / "port", 4, tree)
    back, step = jax_store.restore(tmp_path / "port", jax_tree_like := {
        "a": np.zeros(10, np.float32),
        "nested": {"b": np.zeros((3, 3), ml_dtypes.bfloat16), "step": np.zeros((), np.int32)},
        "lst": [np.zeros(2, np.float32), np.zeros(2, np.float64)]})
    assert step == 4 and back.keys() == jax_tree_like.keys()
    assert back["nested"]["b"].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(back["nested"]["b"].astype(np.float32), np.full((3, 3), 1.5))
    np.testing.assert_array_equal(back["a"], np.arange(10, dtype=np.float32))
    assert int(back["nested"]["step"]) == 7
    ours = np.load(tmp_path / "port" / "step_00000004" / "shard_0.npz")
    theirs = np.load(tmp_path / "ref" / "step_00000003" / "shard_0.npz")
    assert sorted(ours.files) == sorted(theirs.files)


# --------------------------------------------------------------- trainer

def _toy_setup(tmp_path, total=30, ckpt_every=10):
    def init_state():
        return {"params": {"w": torch.zeros(4)},
                "opt": {"m": torch.zeros(4), "v": torch.zeros(4),
                        "step": torch.zeros((), dtype=torch.int32)}}

    def train_step(state, batch):
        w = state["params"]["w"] + 0.1
        step = state["opt"]["step"] + 1
        return ({"params": {"w": w}, "opt": dict(state["opt"], step=step)},
                {"loss": torch.sum(torch.square(w - 3.0))})

    data = SyntheticLM(vocab_size=16, seq_len=4, batch=1)
    cfg = TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                        log_every=1000)
    return cfg, train_step, init_state, data


def _quiet(*_):
    return None


def test_trainer_runs_and_checkpoints(tmp_path):
    cfg, step_fn, init_state, data = _toy_setup(tmp_path)
    out = Trainer(cfg, step_fn, init_state, data, log=_quiet).run()
    assert out["final_step"] == 30
    assert store.latest_step(tmp_path) == 30


def test_trainer_restart_resumes(tmp_path):
    cfg, step_fn, init_state, data = _toy_setup(tmp_path, total=15, ckpt_every=5)
    Trainer(cfg, step_fn, init_state, data, log=_quiet).run()
    cfg2, *_ = _toy_setup(tmp_path, total=30, ckpt_every=5)
    out = Trainer(cfg2, step_fn, init_state, data, log=_quiet).run()
    assert out["final_step"] == 30
    assert float(out["state"]["params"]["w"][0]) == pytest.approx(3.0, rel=1e-5)
    assert int(out["state"]["opt"]["step"]) == 30


def test_trainer_skips_nan_steps(tmp_path):
    calls = {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        return state, {"loss": torch.tensor(float("nan") if calls["n"] == 3 else 1.0)}

    cfg, _, init_state, data = _toy_setup(tmp_path, total=6)
    out = Trainer(cfg, step_fn, init_state, data, log=_quiet).run()
    assert out["final_step"] == 6
    assert len(out["losses"]) == 5


def test_trainer_restores_the_signal_handlers(tmp_path):
    """After ``run()``, returned or raised, SIGTERM and SIGINT have the
    handlers they had before it (the reference leaves its own installed)."""
    before = [signal.getsignal(s) for s in SIGNALS]
    seen = []

    def step_fn(state, batch):
        seen.append([signal.getsignal(s) for s in SIGNALS])
        return state, {"loss": torch.tensor(float("nan"))}

    cfg, ok_step, init_state, data = _toy_setup(tmp_path, total=3)
    Trainer(cfg, ok_step, init_state, data, log=_quiet).run()
    assert [signal.getsignal(s) for s in SIGNALS] == before
    cfg.max_nan_steps = 2
    with pytest.raises(FloatingPointError, match="persistent"):
        Trainer(cfg, step_fn, init_state, data, log=_quiet).run()
    assert [signal.getsignal(s) for s in SIGNALS] == before
    assert seen and all(h != before for h in seen)  # installed while it ran


def test_trainer_preemption_saves_at_its_step(tmp_path):
    cfg, step_fn, init_state, data = _toy_setup(tmp_path, total=30, ckpt_every=100)
    calls = {"n": 0}

    def preempting(state, batch):
        calls["n"] += 1
        if calls["n"] == 4:  # the handler the trainer installed, as SIGTERM would call it
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return step_fn(state, batch)

    out = Trainer(cfg, preempting, init_state, data, log=_quiet).run()
    assert out["final_step"] == 4
    assert store.latest_step(tmp_path) == 4
    restored, _ = store.restore(tmp_path, init_state())
    assert int(restored["opt"]["step"]) == 4


def test_trainer_carries_the_data_state(tmp_path):
    write_corpus(tmp_path / "corpus", n_tokens=2048, vocab_size=32, shard_tokens=500)
    seen = []

    def step_fn(state, batch):
        seen.append(batch["tokens"].copy())
        return state, {"loss": torch.tensor(1.0)}

    def run(total, data):
        cfg = TrainerConfig(total_steps=total, ckpt_dir=str(tmp_path / "ck"), ckpt_every=3,
                            log_every=1000)
        return Trainer(cfg, step_fn, lambda: {"w": torch.zeros(1)}, data, log=_quiet).run()

    run(3, MemmapDataset(tmp_path / "corpus", seq_len=8, batch=2, seed=1))
    resumed = run(5, MemmapDataset(tmp_path / "corpus", seq_len=8, batch=2, seed=1))
    assert resumed["final_step"] == 5
    straight = MemmapDataset(tmp_path / "corpus", seq_len=8, batch=2, seed=1)
    want = [straight.next_batch()["tokens"] for _ in range(5)]
    assert len(seen) == 5 and all(np.array_equal(a, b) for a, b in zip(seen, want))


def test_trainer_straggler_strikes_call_the_elastic_hook(tmp_path, monkeypatch):
    """A fake clock: every step takes 1 s but steps 8-10 take 20 s, three
    strikes of ``max_strikes`` 3."""
    ticks = []
    for step in range(1, 13):
        ticks += [0.0, 20.0 if step in (8, 9, 10) else 1.0]
    clock = iter(ticks)

    class FakeTime:
        @staticmethod
        def time():
            return next(clock)

    monkeypatch.setattr(trainer_mod, "time", FakeTime)
    hooks = []
    cfg, step_fn, init_state, data = _toy_setup(tmp_path, total=12, ckpt_every=100)
    cfg.max_strikes = 3
    out = Trainer(cfg, step_fn, init_state, data, elastic_hook=hooks.append, log=_quiet).run()
    assert out["final_step"] == 12
    assert [h["step"] for h in hooks] == [10] and hooks[0]["last"] == 20.0


def test_trainer_leaves_no_thread_behind(tmp_path):
    threads = threading.active_count()
    cfg, step_fn, init_state, data = _toy_setup(tmp_path, total=5, ckpt_every=2)
    with Prefetcher(iter(data)) as pre:
        Trainer(cfg, step_fn, init_state, pre, log=_quiet).run()
    assert threading.active_count() == threads
