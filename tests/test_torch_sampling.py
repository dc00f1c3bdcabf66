"""Port parity: ``filter_logits`` / ``sample_logits`` against the JAX functions.

200 seeded cases of (B, V) logits with temperature, top-k, top-p and ties
(logits drawn from a few integer levels, so many tokens share a value). The
filtered logits must keep and drop the same tokens (equal ``-inf`` masks) and
agree on the kept values to 1e-6 relative (fp32: the same division, softmax
and cumulative sums in another order). Sampling with ``top_k=1`` or
``top_p=0`` equals greedy on both sides, and a sampled token always lies in
the kept set.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)
from deepspeed_tpu.inference.generation import filter_logits as jax_filter_logits
from deepspeed_tpu.inference.generation import sample_logits as jax_sample_logits
from deepspeed_tpu_torch.inference.generation import filter_logits, sample_logits

CASES = 200


def _case(i):
    rng = np.random.default_rng(i)
    B, V = (1, 8) if i % 3 == 0 else (3, 33) if i % 3 == 1 else (2, 64)  # few shapes: JAX compiles per shape
    if i % 2:  # ties: a few levels shared by many tokens
        logits = rng.integers(-3, 4, (B, V)).astype(np.float32) * 0.75
    else:
        logits = (rng.standard_normal((B, V)) * rng.uniform(0.5, 4.0)).astype(np.float32)
    temperature = float(rng.choice([0.3, 0.7, 1.0, 1.5, 1e-7]))
    top_k = int(rng.choice([0, 1, 3, V // 2, V]))  # k <= V, as both frameworks require
    top_p = float(rng.choice([1.0, 0.95, 0.7, 0.3, 0.0]))
    return logits, temperature, top_k, top_p


@pytest.mark.parametrize("block", range(4))
def test_filter_logits_equals_jax(block):
    for i in range(block * CASES // 4, (block + 1) * CASES // 4):
        logits, temperature, top_k, top_p = _case(i)
        want = np.asarray(jax_filter_logits(jnp.asarray(logits), temperature, top_k, top_p))
        got = filter_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
        kept = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), kept, err_msg=f"case {i}")
        assert kept.any(axis=-1).all()
        scale = np.abs(want[kept]).max() if kept.any() else 1.0
        assert np.abs(got[kept] - want[kept]).max() <= 1e-6 * max(scale, 1.0), f"case {i}"


@pytest.mark.parametrize("block", range(2))
def test_sampling_keeps_to_the_filtered_set_and_top1_is_greedy(block):
    for i in range(block * CASES // 2, (block + 1) * CASES // 2):
        logits, temperature, top_k, top_p = _case(i)
        t = torch.from_numpy(logits)
        gen = torch.Generator().manual_seed(i)
        kept = np.isfinite(filter_logits(t, temperature, top_k, top_p).numpy())
        tok = sample_logits(t, gen, True, temperature, top_k, top_p).numpy()
        assert kept[np.arange(len(tok)), tok].all(), f"case {i}"
        greedy = np.argmax(logits, axis=-1)
        unique_max = (logits == logits.max(-1, keepdims=True)).sum(-1) == 1
        for k, p in ((1, 1.0), (0, 0.0)):
            for fn in (lambda *a: sample_logits(t, gen, *a).numpy(),
                       lambda *a: np.asarray(jax_sample_logits(jnp.asarray(logits), jax.random.PRNGKey(i), *a))):
                got = fn(True, 1.0, k, p)
                np.testing.assert_array_equal(got[unique_max], greedy[unique_max], err_msg=f"case {i}")
        np.testing.assert_array_equal(sample_logits(t, gen, False, temperature, top_k, top_p).numpy(), greedy)
        np.testing.assert_array_equal(sample_logits(t, gen, True, 0.0, top_k, top_p).numpy(), greedy)
