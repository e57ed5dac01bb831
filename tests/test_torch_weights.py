"""The weight bridge on the repo's trained checkpoints: each loads into the
full-width port with every checkpoint leaf consumed and every tensor
filled, and stage A (MnasNet + FPN) then matches the JAX package on one
64x80 image."""
import os

import numpy as np
import pytest
import torch

from _torch_helpers import flax_apply, n
from _torch_helpers import torch_one_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKPOINTS = ["weights/3dvnet_synth48.npz",
               "results/r4_synth48/3dvnet_synth48_r4.npz"]


@pytest.mark.parametrize("path", CHECKPOINTS)
def test_checkpoint_loads_into_full_width_port(path):
    from tdvnet.train.checkpoints import load_npz as jax_load_npz
    from tdvnet_torch.config import ModelConfig
    from tdvnet_torch.weights import from_flax_variables, load_npz, \
        load_threedvnet

    full = os.path.join(ROOT, path)
    model = load_threedvnet(full, ModelConfig(), device="cpu")
    assert not model.training
    variables, epoch = load_npz(full)
    jvars, jepoch = jax_load_npz(full)
    assert epoch == jepoch
    sd = from_flax_variables(variables)
    own = {k: v for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert torch.equal(own[k], v), k
    n_params = sum(p.numel() for p in model.parameters())
    n_flax = sum(np.asarray(a).size for a in _leaves(jvars["params"]))
    assert n_params == n_flax > 11_000_000


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_stage_a_full_width_matches_jax_with_trained_weights():
    from tdvnet.models.mvsnet import MVSNet as J
    from tdvnet.train.checkpoints import load_npz as jax_load_npz
    from tdvnet_torch.data import synthetic
    from tdvnet_torch.weights import load_threedvnet

    full = os.path.join(ROOT, CHECKPOINTS[0])
    jvars, _ = jax_load_npz(full)
    mv = {c: jvars[c]["mvsnet"] for c in ("params", "batch_stats")}
    img = synthetic.make_scene(1, (64, 80), seed=9)["images"]
    a = flax_apply(J(), mv, img, method=J.extract_features)
    model = load_threedvnet(full, device="cpu")
    with torch.no_grad():
        b = model.extract_features(torch.from_numpy(img))
    for x, y in zip(a, b):
        assert x.shape == tuple(y.shape)
        # 17 BN'd fp32 conv layers of the trained net, features of O(1-10)
        np.testing.assert_allclose(np.asarray(x), n(y), rtol=1e-4, atol=2e-4)
        assert np.abs(np.asarray(x)).max() > 0.5
