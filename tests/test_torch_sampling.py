"""The port's decoding rules against the JAX ``sampling.apply_rules``,
both branches (no-timestamps and the timestamp grammar)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.config import get_config
from whisper_tpu.sampling import RuleState as JaxRuleState
from whisper_tpu.sampling import apply_rules as jax_apply_rules
from whisper_tpu_torch.config import get_config as port_config
from whisper_tpu_torch.sampling import RuleState, apply_rules

CFG = get_config("tiny")
PCFG = port_config("tiny")


def _states():
    """Per-stream histories covering the grammar's cases: nothing sampled,
    after text, after one timestamp, after a [ts, ts] pair, after
    [text, ts], and a running max above the newest stamp."""
    ts0, eot = CFG.timestamp_begin, CFG.eot
    last = [-1, 400, ts0 + 7, ts0 + 9, ts0 + 12, 500]
    penult = [-1, 300, 200, ts0 + 9, 311, ts0 + 30]
    max_ts = [0, 0, ts0 + 7, ts0 + 9, ts0 + 12, ts0 + 30]
    n = [0, 2, 2, 5, 3, 6]
    assert eot < ts0
    return last, penult, max_ts, n


@pytest.mark.parametrize("timestamps", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_apply_rules_matches_jax(timestamps, seed):
    rng = np.random.default_rng(seed)
    last, penult, max_ts, n = _states()
    logits = (rng.standard_normal((len(last), CFG.n_vocab)) * 3).astype(np.float32)
    if seed:  # make the timestamp mass win on some rows
        logits[::2, CFG.timestamp_begin:] += 6.0
    suppress = np.asarray([10, 220, 1000, CFG.sot, CFG.no_speech], np.int32)

    ref = jax_apply_rules(jnp.asarray(logits),
                          JaxRuleState(*(jnp.asarray(a, jnp.int32) for a in (last, penult, max_ts, n))),
                          CFG, suppress_ids=jnp.asarray(suppress), timestamps=timestamps)
    got = apply_rules(torch.from_numpy(logits),
                      RuleState(*(torch.tensor(a) for a in (last, penult, max_ts, n))),
                      PCFG, suppress_ids=torch.from_numpy(suppress).long(), timestamps=timestamps)
    np.testing.assert_array_equal(got.numpy() <= -1e29, np.asarray(ref) <= -1e29)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=0)


def test_rule_state_advance_matches_jax():
    last, penult, max_ts, n = _states()
    sampled = [CFG.timestamp_begin + 40, 17, CFG.timestamp_begin + 3, 9, CFG.eot, 5]
    ref = JaxRuleState(*(jnp.asarray(a, jnp.int32) for a in (last, penult, max_ts, n))
                       ).advance(jnp.asarray(sampled, jnp.int32), CFG.timestamp_begin)
    got = RuleState(*(torch.tensor(a) for a in (last, penult, max_ts, n))
                    ).advance(torch.tensor(sampled), PCFG.timestamp_begin)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
