"""The port's bfloat16 train step against JAX's bfloat16 step evaluated as
written: the same jitted value_and_grad as test_torch_train_bf16.py's,
compiled with `xla_allow_excess_precision=False`, so that XLA's CPU backend
rounds each bfloat16 op of the JAX program to bfloat16 where it otherwise
keeps a fusion's elementwise chain in float32. PyTorch rounds each op, so
this is the cause of test_torch_train_bf16.py's exception to "at most 1 x
JAX's own bfloat16-to-float32 gap", and this file shows it: against this
step most parameters lie within 1 x, and so do the three largest
exceptions there. Its own file, so that each stays under a minute.

Same size, weights, batch, draws and fine samples as
test_torch_train_bf16.py; the float32 side of each gap is the port's
float32 step, as there.
"""
import jax
import numpy as np
import pytest

from test_torch_train_bf16 import (FAST, GROUPS16, TRAIN_CFG, BF16_CFG,
                                   _grad_stats, _jax_step, _port_step,
                                   one_thread)  # noqa: F401 (autouse)

AS_WRITTEN = dict(FAST, xla_allow_excess_precision=False)
# the share of parameters above GRAD_FLOOR beyond 1 x JAX's own gap (40 of
# 345 measured, where 171 are against the default step), and each group's
# median (0.45-0.92 measured, 0.82-1.32 against the default step)
BEYOND_SHARE, GAP_MEDIAN = 0.2, 1.0
# test_torch_train_bf16.py's three largest ratios, beside the ratio that
# the same parameter reads here (measured)
NAMED = {"nr_net.agg_net.agg_impl.neuray_fc.2.bias": (4.14, 0.26),
         "nr_net.dist_decoder.var_decoder.0.bias": (3.42, 0.57),
         "nr_net.fine_agg_net.prob_embed.0.weight": (3.31, 0.73)}


@pytest.fixture(scope="module")
def stats():
    """{group: _grad_stats rows} against JAX's step as written."""
    jax_run = _jax_step(AS_WRITTEN)
    got = _port_step(jax_run, BF16_CFG)["grads"]
    ref = _port_step(jax_run, TRAIN_CFG)["grads"]
    grads = jax.tree_util.tree_map(np.asarray, jax_run["grads"])
    return {g: _grad_stats(grads, got, ref, g) for g in GROUPS16}


@pytest.mark.parametrize("group", GROUPS16)
def test_group_median_within_jax_gap_as_written(stats, group):
    """Each group's median ratio to JAX's own gap within GAP_MEDIAN."""
    rows = stats[group]
    assert rows[len(rows) // 2][0] <= GAP_MEDIAN, rows


def test_most_gradients_within_jax_gap_as_written(stats):
    """At most BEYOND_SHARE of the parameters lie beyond 1 x JAX's own gap,
    and the three largest ratios of the default step lie within 1 x
    here."""
    rows = [r for g in GROUPS16 for r in stats[g]]
    beyond = [r for r in rows if r[0] > 1.0]
    assert len(beyond) <= BEYOND_SHARE * len(rows), (len(beyond), len(rows))
    ratio = {r[3]: r[0] for r in rows}
    for name in NAMED:
        assert ratio[name] <= 1.0, (name, ratio[name], NAMED[name])
