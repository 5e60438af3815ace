"""The port's fine-tuning and serving twins against the JAX examples, on the
reduced llama3 in fp32 on the CPU: ``examples/multi_finetune_torch.py``
(two trainers, one shared backward a tick) and
``examples/unified_serving_torch.py`` (30 requests at 2 RPS beside a
trainer, virtual clock).  The set-up is ``test_torch_examples.py``'s: each
JAX example runs once, its weights are rebuilt in JAX from its keys and
handed to the twin; counts, SLO attainment and finished requests equal what
it prints, and a printed loss is held within ``LOSS_TOL`` of the twin's.
"""
import re

import numpy as np
import pytest
import torch

from _torch_bridge import close_to_print, example_stdout, jax_weights, \
    load_example
from repro_torch.configs import get_reduced


@pytest.fixture(scope="module")
def multi_finetune(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multi_finetune")
    out = example_stdout("multi_finetune")
    weights = jax_weights(tmp, {"alpaca": 2, "gsm8k": 3})
    return out, load_example("multi_finetune_torch").run(
        get_reduced("llama3-8b"), "cpu", torch.float32, weights=weights)


@pytest.mark.parametrize("name", ["alpaca", "gsm8k"])
def test_multi_finetune_twin_prints_what_jax_prints(multi_finetune, name):
    """Each trainer's first and last train losses (means of six), its last
    eval loss and its optimizer steps."""
    text, got = multi_finetune
    m = re.search(rf"^{name}: loss ([\d.]+) -> ([\d.]+), eval ([\d.]+), "
                  rf"opt_steps=(\d+)$", text, re.M)
    tr = got["trainers"][name]
    assert tr["opt_steps"] == int(m.group(4)) >= 1
    close_to_print(m.group(1), tr["loss_first"])
    close_to_print(m.group(2), tr["loss_last"])
    close_to_print(m.group(3), tr["eval"])
    assert tr["tokens_trained"] > 0
    assert np.isfinite(tr["train_losses"] + tr["eval_losses"]).all()


@pytest.fixture(scope="module")
def unified_serving(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unified_serving")
    out = example_stdout("unified_serving")
    weights = jax_weights(tmp, {"chat": 2, "math": 3, "student": 4})
    return out, load_example("unified_serving_torch").run(
        get_reduced("llama3-8b"), "cpu", torch.float32, weights=weights)


def test_unified_serving_twin_slo_and_finished_match_jax(unified_serving):
    """SLO attainment under the virtual clock and the finished count:
    every request finishes with its 12 tokens."""
    text, got = unified_serving
    m = re.search(r"SLO attainment: ([\d.]+) \((\d+)/30 finished\)", text)
    assert f"{got['slo']:.3f}" == m.group(1)
    assert got["finished"] == int(m.group(2)) == 30
    assert all(len(toks) == 12 for toks in got["tokens"].values())


def test_unified_serving_twin_trainer_matches_jax(unified_serving):
    """The student's trained tokens, optimizer steps and first and last
    losses (means of four)."""
    text, got = unified_serving
    m = re.search(r"student: (\d+) tokens trained, (\d+) optimizer steps, "
                  r"loss ([\d.]+) -> ([\d.]+)", text)
    assert got["tokens_trained"] == int(m.group(1)) > 0
    assert got["opt_steps"] == int(m.group(2)) >= 1
    close_to_print(m.group(3), got["loss_first"])
    close_to_print(m.group(4), got["loss_last"])
