"""Port parity: Hugging Face checkpoints served at tensor_parallel = 2.

The JAX package loads each checkpoint born sharded on this suite's 8 forced
host devices (a ``data`` 4 x ``tensor`` 2 mesh, ``load_hf_checkpoint(...,
mesh=, shard=True)``) and serves it through ``init_inference`` at
``tp_size`` 2, as ``tests/unit/test_hf_interop_archs.py``'s
``test_new_arch_tp2_serving`` (gemma, falcon 40b-style, stablelm) and
``test_bert_tp2_serving`` do. The port runs two gloo ranks on the CPU
(``torch_hf_models.tp_logits``, one spawn for every model): each rank loads
its slice of every leaf (``load_hf_checkpoint(tp_size=2, rank=r)``) and
serves it through the v1 engine at ``tp_size`` 2, and again from the path
(``init_inference(<directory>)``, which loads and keeps the rank's slice).
Held: both ranks' logits, both ways, within 1e-5 of JAX tp 2's relative to
max |logit| (the same fp32 math; the vocab-parallel head and the
row-parallel sums add in another order), and within the JAX test's 5e-4 of
the Hugging Face model's.
"""

import numpy as np
import pytest

import torch_test_threads  # noqa: F401  (caps torch's CPU threads)

transformers = pytest.importorskip("transformers")

import deepspeed_tpu  # noqa: E402
import torch_hf_models as hm  # noqa: E402
import torch_zero_worker as zw  # noqa: E402
from deepspeed_tpu.module_inject import load_hf_checkpoint as jax_load  # noqa: E402
from deepspeed_tpu.parallel.mesh import initialize_mesh  # noqa: E402
from deepspeed_tpu.runtime.config import MeshConfig  # noqa: E402

TP = 2
JAX_TOL = 1e-5
HF_TOL = dict(rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """The checkpoints, their Hugging Face logits and what each rank served."""
    root = tmp_path_factory.mktemp("hf_tp")
    dirs, ref = {}, {}
    for name, seed in hm.TP_ARCHS.items():
        tm = hm.build(name, seed=seed)
        dirs[name] = hm.save(tm, root / name)
        ref[name] = hm.hf_logits(tm, hm.IDS)
    out = root / "out"
    out.mkdir()
    zw.spawn(TP, hm.tp_logits, dirs, str(out))
    got = {name: {(r, way): np.load(out / f"{name}_{r}_{way}.npy") for r in range(TP) for way in ("loaded", "path")}
           for name in dirs}
    return dirs, ref, got


@pytest.mark.parametrize("name", list(hm.TP_ARCHS))
def test_tp2_serving_matches_jax_tp2(served, name):
    dirs, ref, got = served
    topo = initialize_mesh(MeshConfig.from_dict({"data": 4, "tensor": TP}), force=True)
    model, params = jax_load(dirs[name], mesh=topo, shard=True)
    eng = deepspeed_tpu.init_inference(model, config={"tensor_parallel": {"tp_size": TP}, "dtype": "fp32"},
                                       params=params, mesh=topo)
    want = np.asarray(eng.forward(hm.IDS))
    np.testing.assert_allclose(want, ref[name], **HF_TOL)
    for key, logits in got[name].items():
        rel = float(np.max(np.abs(logits - want)) / np.max(np.abs(want)))
        assert rel <= JAX_TOL, (key, rel)
        np.testing.assert_allclose(logits, ref[name], **HF_TOL)
