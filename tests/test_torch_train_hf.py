"""Port parity: training the Hugging Face families from a checkpoint.

Each case builds a tiny seeded ``transformers`` model (``torch_hf_models``),
saves it with ``save_pretrained`` and loads the directory through the JAX
``load_hf_checkpoint`` and the port's (``device="cpu"``), the path a user
takes to fine-tune: ``CausalLM(config_from_hf(config.json))`` with the loaded tree.
Held, for phi (``parallel_shared``, partial rotary, head bias, untied),
gemma (``embed_scale``, the (1 + w) RMSNorm, GQA, tied head through the
fused CE), gpt-j (``rotary_dims``, interleaved rotary), gpt-neox (parallel
residual, partial rotary), qwen3 (``qk_norm``) and olmo (``clip_qkv``, norms
without parameters):

- ``CausalLM.loss_fn`` and every leaf's gradient against JAX
  ``jax.value_and_grad`` of its ``loss_fn`` on the same numpy batch: the
  loss within 1e-5 relative and each gradient within 1e-5 of the largest
  gradient of its leaf (fp32 in both packages, the same math in another
  summation order; measured at most 1e-6; ``k_proj``'s bias, whose true
  gradient is zero, of the model's largest);
- the engine's squared gradient norm of a leaf of 2^24 elements on the CPU
  within 1e-6 of float64 (``torch.linalg.vector_norm`` there sums in order
  and is 6.5e-4 off; at phi-2's ``wte``, 131 M elements, 1.3 %, which the
  card run of a 2-layer fp32 step against the CPU route showed);
- three FusedAdam steps of ``deepspeed_tpu_torch.initialize`` against the
  JAX engine on a one-device mesh from the same checkpoint and batches
  (phi): losses within 2e-5 and every parameter after the last step within
  2 % of the Adam travel (``test_torch_train_engine.py``'s tolerances).
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)

pytest.importorskip("transformers")
pytest.importorskip("safetensors.torch")

import jax  # noqa: E402

import deepspeed_tpu  # noqa: E402
import deepspeed_tpu_torch  # noqa: E402
import torch_hf_models as hm  # noqa: E402
from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load  # noqa: E402
from deepspeed_tpu.parallel.mesh import MeshTopology  # noqa: E402
from deepspeed_tpu.runtime.config import MeshConfig  # noqa: E402
from deepspeed_tpu_torch.models import CausalLM  # noqa: E402
from deepspeed_tpu_torch.module_inject import config_from_hf, load_hf_checkpoint  # noqa: E402

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
FAMILIES = ["phi", "gemma", "gptj", "gpt_neox", "qwen3", "olmo_clip_qkv"]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def _hf_config(d):
    with open(os.path.join(d, "config.json")) as fh:
        return config_from_hf(json.load(fh))


def _ids(seed, rows=2, length=16, vocab=128):
    return np.random.default_rng(seed).integers(0, vocab, (rows, length)).astype(np.int32)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_loss_and_gradients_match_jax(tmp_path, family):
    d = hm.save(hm.build(family), tmp_path)
    jm, jp = jax_load(d)
    pm, pp = load_hf_checkpoint(d, device="cpu")
    cfg = _hf_config(d)
    assert cfg == pm.cfg
    model = CausalLM(cfg)
    ids = _ids(FAMILIES.index(family))
    want_loss, want_grads = jax.jit(jax.value_and_grad(lambda p: jm.loss_fn(p, {"input_ids": ids})))(jp)
    leaves = _flat(pp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = model.loss_fn(pp, {"input_ids": torch.from_numpy(ids.astype(np.int64))})
    loss.backward()
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * abs(float(want_loss))
    want = _flat(jax.tree.map(np.asarray, want_grads))
    assert set(want) == set(leaves)
    top = max(float(np.abs(w).max()) for w in want.values())
    for path, w in want.items():
        # k_proj's bias has a zero true gradient (softmax ignores a per-row constant): fp32 noise on both sides
        scale = top if path.endswith("k_proj/bias") else max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(leaves[path].grad.numpy() - w).max()) <= GRAD_TOL * scale, path


def _config():
    return {"train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1, "steps_per_print": 1000,
            "optimizer": {"type": "FusedAdam", "params": {"lr": 1e-3, "weight_decay": 0.01}},
            "gradient_clipping": 1.0}


def test_three_engine_steps_from_a_checkpoint_match_the_jax_engine(tmp_path):
    d = hm.save(hm.build("phi"), tmp_path)
    batches = [{"input_ids": _ids(10 + i)} for i in range(3)]
    jm, jp = jax_load(d)
    jeng, _, _, _ = deepspeed_tpu.initialize(
        model=jm, model_parameters=jax.tree.map(np.asarray, jp), config=_config(),
        mesh=MeshTopology(MeshConfig.from_dict({"data": 1}), devices=jax.devices()[:1]))
    pm, pp = load_hf_checkpoint(d, device="cpu")
    engine, _, _, _ = deepspeed_tpu_torch.initialize(model=CausalLM(_hf_config(d)), model_parameters=pp,
                                                     config=_config(), device="cpu")
    jit, it = iter(batches), iter(batches)
    for _ in range(3):
        jl, tl = float(jeng.train_batch(jit)), float(engine.train_batch(it))
        assert abs(tl - jl) <= 2e-5, (tl, jl)
    want = _flat(jax.tree.map(np.asarray, jeng.params))
    got = _flat(engine.module_state_dict())
    assert set(got) == set(want)
    travel = 3 * 1e-3  # the most an element can move under Adam at lr 1e-3
    for path in want:
        tol = 2 * travel if path.endswith("k_proj/bias") else 0.02 * travel  # as test_torch_train_engine.py
        np.testing.assert_allclose(got[path].numpy(), want[path], atol=tol, rtol=0, err_msg=path)


def test_the_engine_norm_of_a_large_leaf_is_exact_on_the_cpu():
    from deepspeed_tpu_torch.runtime.engine import _squared_norm

    g = torch.randn(1 << 24, generator=torch.Generator().manual_seed(0))
    want = float(g.double().square().sum())
    assert abs(float(_squared_norm(g)) - want) <= 1e-6 * want
