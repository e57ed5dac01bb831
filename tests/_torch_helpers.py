"""Shared helpers of the port's tests: run a flax module and its torch port
on the same seeded numpy inputs and the same weights."""
import dataclasses

import jax
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One torch thread while a module of the port's tests runs (a module
    imports this fixture to use it). Their tensors are tiny, where torch's
    thread pool costs more than it gains, and the test workers run side by
    side, each with a pool of one thread per core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def flax_variables(module, *args, seed=0, perturb=True, **kwargs):
    """Initialise a flax module and return its variables as numpy. With
    `perturb`, every BatchNorm/GroupNorm scale, bias and running statistic
    is moved off its init value (ones/zeros), so a swapped or dropped leaf
    shows in the outputs."""
    # jitted with the inputs as constants: eager flax init runs op by op
    vs = jax.jit(lambda key: module.init(key, *args, **kwargs))(
        jax.random.PRNGKey(seed))
    vs = jax.tree.map(np.asarray, dict(vs))
    if not perturb:
        return vs
    rng = np.random.default_rng(seed + 1000)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in ("scale", "bias", "mean"):
                out[k] = (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return {c: walk(dict(tree)) for c, tree in vs.items()}


def flax_apply(module, variables, *args, **kwargs):
    """`module.apply` jitted, with the inputs as constants."""
    return jax.jit(lambda v: module.apply(v, *args, **kwargs))(variables)


def torch_module(module, variables):
    from tdvnet_torch.weights import load_flax_into

    load_flax_into(module, variables)
    return module.eval()


def jax_tiny_config():
    """The JAX package's tiny config with the exact gather warp."""
    from tdvnet.config import tiny_test_config

    cfg = tiny_test_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, warp_mode="gather"))


def tiny_scenes(cfg, seeds):
    from tdvnet_torch.data import synthetic

    bc = cfg.batch
    return [synthetic.make_batch_scene(bc.n_views, bc.img_size,
                                       bc.depth_img_size, seed=s,
                                       n_src_on_either_side=bc.n_src_on_either_side)
            for s in seeds]


def both_batches(cfg, seeds):
    """The same collated scenes as a JAX FrameBatch and a port FrameBatch."""
    from tdvnet.data import batch as JB
    from tdvnet_torch.data import batch as TB

    bc = cfg.batch
    scenes = tiny_scenes(cfg, seeds)
    args = (bc.n_views, bc.n_ref, bc.n_src_on_either_side)
    return JB.collate_scenes(scenes, *args), TB.collate_scenes(scenes, *args)


def t(x):
    """numpy / jax array -> torch CPU tensor (ints as int64), a copy (a
    jax array's numpy view is read-only)."""
    a = np.array(x)
    if np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def n(x):
    """torch tensor / jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
