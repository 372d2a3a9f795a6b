"""The port's data pipeline and fault-tolerance runtime against the JAX
reference's on the CPU: batches bit-equal at several (seed, step, shard),
and ``run_with_restarts`` as ``tests/test_substrate.py:161-200`` drives the
reference's, plus the watchdog's ``sync`` hook (the port's one addition)."""
import numpy as np
import pytest

from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokenPipeline as JaxPipeline
from repro.runtime import fault as jax_fault
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.runtime import (FaultConfig, FaultInjector, SimulatedFailure,
                                 Watchdog, run_with_restarts)


@pytest.mark.parametrize("seed,vocab,seq,batch", [
    (1234, 128, 32, 4), (1, 152064, 64, 8), (7, 51865, 17, 6)])
@pytest.mark.parametrize("step", [0, 1, 13, 1000])
def test_batches_bit_equal(seed, vocab, seq, batch, step):
    ref = JaxPipeline(JaxDataConfig(vocab=vocab, seq_len=seq,
                                    global_batch=batch, seed=seed))
    port = SyntheticTokenPipeline(DataConfig(vocab=vocab, seq_len=seq,
                                             global_batch=batch, seed=seed))
    want, got = ref.global_batch_at(step), port.global_batch_at(step)
    assert sorted(got) == ["labels", "tokens"]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.int32
        assert np.array_equal(got[k], want[k])
    for n_shards in (2, batch):
        for shard in (0, n_shards - 1):
            w = ref.shard_batch_at(step, shard, n_shards)
            g = port.shard_batch_at(step, shard, n_shards)
            assert all(np.array_equal(g[k], w[k]) for k in w)


def test_shards_tile_the_global_batch():
    port = SyntheticTokenPipeline(DataConfig(vocab=100, seq_len=8,
                                             global_batch=6))
    full = port.global_batch_at(3)["tokens"]
    parts = [port.shard_batch_at(3, s, 3)["tokens"] for s in range(3)]
    assert np.array_equal(np.concatenate(parts), full)


def _drive(runtime, fail_at, total=20, save_every=5):
    executed, store = [], {}

    def init_state():
        return {"sum": 0, "last": -1}

    def step_fn(state, step):
        executed.append(step)
        return {"sum": state["sum"] + step, "last": step}

    def save_fn(state, step):
        store["ckpt"] = (dict(state), step)

    def restore_fn():
        return (dict(store["ckpt"][0]), store["ckpt"][1]) \
            if "ckpt" in store else None

    inj = runtime.FaultInjector(fail_at_steps=fail_at)
    out = runtime.run_with_restarts(
        total_steps=total, init_state=init_state, step_fn=step_fn,
        save_fn=save_fn, restore_fn=restore_fn, save_every=save_every,
        injector=inj)
    return out, executed, inj


@pytest.mark.parametrize("fail_at", [[], [7, 13], [0], [4, 5, 19]])
def test_run_with_restarts_matches_reference(fail_at):
    import repro_torch.runtime.fault as port_fault
    out, executed, inj = _drive(port_fault, fail_at)
    ref, ref_executed, ref_inj = _drive(jax_fault, fail_at)
    assert out["restarts"] == ref["restarts"] == len(fail_at)
    assert out["completed_steps"] == ref["completed_steps"] == 20
    assert out["state"] == ref["state"] == {"sum": sum(range(20)),
                                            "last": 19}
    assert executed == ref_executed
    assert inj.fired == ref_inj.fired == sorted(fail_at)
    assert len(out["watchdog"].durations) == len(executed)


def test_run_with_restarts_gives_up_after_budget():
    def step_fn(state, step):
        if step == 1:
            raise SimulatedFailure("always")
        return state

    with pytest.raises(SimulatedFailure):
        run_with_restarts(total_steps=5, init_state=dict, step_fn=step_fn,
                          save_fn=lambda s, t: None, restore_fn=lambda: None,
                          fault=FaultConfig(max_restarts=2), injector=None)


def test_watchdog_syncs_before_reading_its_clock():
    calls = []
    wd = Watchdog(deadline_s=0.0, sync=lambda: calls.append("sync"))
    wd.start()
    wd.stop(3)
    assert calls == ["sync"] and wd.violations == [3]
    syncs = []
    run_with_restarts(total_steps=4, init_state=dict,
                      step_fn=lambda s, t: s, save_fn=lambda s, t: None,
                      restore_fn=lambda: None, sync=lambda: syncs.append(1))
    assert len(syncs) == 4
    assert FaultInjector([2]).fail_at == {2}
