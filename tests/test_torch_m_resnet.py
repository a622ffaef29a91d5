"""The port's CLIP ModifiedResNet against the JAX one, on converted weights,
at a narrow width on the CPU.  Tolerance atol 1e-4 on the float32 output:
the convolutions sum in another order on the two sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models.m_resnet import ModifiedResNet as JaxModifiedResNet
from textreid_torch.models.m_resnet import ModifiedResNet
from textreid_torch.utils.weight_convert import _visual

torch.set_num_threads(2)

SPEC = dict(layers=(1, 1, 1, 1), output_dim=16, heads=2, last_stride=1,
            input_resolution=(64, 32), width=8)


def randomized(tree, rng):
    """Replace every leaf with seeded values of its shape; BN scales and
    variances stay positive so the trunk is well conditioned."""
    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "var" in name or "scale" in name:
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


@pytest.mark.parametrize("last_stride", [1, 2])
def test_modified_resnet_matches_jax(last_stride):
    spec = dict(SPEC, last_stride=last_stride)
    rng = np.random.RandomState(last_stride)
    x = rng.randn(2, 64, 32, 3).astype(np.float32)  # NHWC, normalized
    jax_net = JaxModifiedResNet(**spec)
    variables = randomized(
        jax_net.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(jax_net.apply(variables, jnp.asarray(x)))

    net = ModifiedResNet(**spec).eval()
    sd = {}
    _visual(sd, "", variables["params"], variables["batch_stats"])
    net.load_state_dict({k: torch.from_numpy(np.array(v))
                         for k, v in sd.items()})
    with torch.no_grad():
        got = net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_reference_key_names():
    """CLIP's torch names, so reference state dicts load as they are."""
    keys = set(ModifiedResNet(**SPEC).state_dict())
    for k in ("layer1.0.downsample.0.weight", "layer1.0.downsample.1.running_var",
              "attnpool.positional_embedding", "attnpool.c_proj.bias",
              "bn3.num_batches_tracked", "layer4.0.conv3.weight"):
        assert k in keys, k


def test_grid_too_small_is_an_error():
    with pytest.raises(ValueError, match="too small"):
        ModifiedResNet(**dict(SPEC, input_resolution=(8, 8)))
