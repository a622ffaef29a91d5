"""The port's torchvision-layout ResNet against the JAX one
(``textreid_tpu/models/resnet.py``), on weights carried over by
``state_dict_from_jax``'s ResNet export, on the CPU.

resnet18 (basic blocks) and resnet50 (bottlenecks) at their published
widths on 64x32 inputs, with res5 stride 2 and 1 and, at stride 1,
dilation 2.  Eval mode (running statistics moved off their initial
values), f32: the outputs within TOL = 1e-5 of the largest |output|.

Train mode (batch statistics; the running ones moved with flax's momentum
0.9 towards the biased variance): a deep trunk normalised on a small
batch's statistics is ill-conditioned in f32 (resnet50's output moves by
up to 1.5e-4 of its largest entry between the port's f32 and f64 runs,
JAX's f32 by 5.7e-4), so the parity of the two packages' train-mode
arithmetic is held in f64 on both sides: output and every running
statistic within TOL of the tensor's largest entry.  In f32 the port is
held to be no less accurate than the reference: its output's distance to
the f64 output at most twice JAX's f32 output's.
"""

import copy
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models.resnet import ResNet as JaxResNet
from textreid_torch.config import get_default_cfg
from textreid_torch.models import build_model
from textreid_torch.models.resnet import ARCH_LAYERS, ResNet
from textreid_torch.utils.weight_convert import _visual

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
CASES = [("resnet18", 2, 1), ("resnet18", 1, 2), ("resnet50", 2, 1),
         ("resnet50", 1, 1), ("resnet50", 1, 2)]


def randomized(tree, rng):
    """Seeded values of every leaf's shape: BatchNorm scales and running
    variances in [0.5, 1.5), convolutions N(0, 1 / fan-in) (so a deep
    trunk stays O(1)), everything else N(0, 0.1^2)."""
    def leaf(path, x):
        name = jax.tree_util.keystr(path)
        if "var" in name or "scale" in name:
            return (rng.rand(*x.shape) + 0.5).astype(np.float32)
        if "kernel" in name:
            fan_in = int(np.prod(x.shape[:-1]))
            return (rng.randn(*x.shape) * np.sqrt(1.0 / fan_in)).astype(
                np.float32)
        return (rng.randn(*x.shape) * 0.1).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _pair(arch, stride, dilation, seed):
    block, layers = ARCH_LAYERS[arch]
    rng = np.random.RandomState(seed)
    x = rng.randn(4, 64, 32, 3).astype(np.float32)  # NHWC, normalized
    jax_net = JaxResNet(block=block, layers=layers, res5_stride=stride,
                        res5_dilation=dilation)
    variables = randomized(
        jax_net.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    net = ResNet(block, layers, res5_stride=stride, res5_dilation=dilation)
    net.load_state_dict(_port_sd(variables))
    return jax_net, variables, net, x


def _port_sd(variables) -> dict:
    sd = {}
    _visual(sd, "", variables["params"], variables["batch_stats"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("arch,stride,dilation", CASES)
def test_resnet_matches_jax_in_eval_mode(arch, stride, dilation):
    jax_net, variables, net, x = _pair(arch, stride, dilation, seed=stride)
    want = np.asarray(jax_net.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (4, net.out_channels) == want.shape
    _close(got, want, "eval output")


@pytest.mark.parametrize("arch,stride,dilation", CASES)
def test_resnet_matches_jax_in_train_mode(arch, stride, dilation):
    jax_net, variables, net, x = _pair(arch, stride, dilation, seed=stride)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    net64 = copy.deepcopy(net).double().train()
    with torch.no_grad():
        got32 = net.train()(xt).numpy()
        got = net64(xt.double()).numpy()
    with jax.enable_x64(True):
        block, layers = ARCH_LAYERS[arch]
        jax64 = JaxResNet(block=block, layers=layers, res5_stride=stride,
                          res5_dilation=dilation, dtype=jnp.float64)
        want, updates = jax64.apply(
            jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables),
            jnp.asarray(x, jnp.float64), train=True,
            mutable=["batch_stats"])
        want = np.asarray(want)
        moved = _port_sd({"params": variables["params"],
                          "batch_stats": jax.tree.map(
                              np.asarray, updates["batch_stats"])})
    assert want.dtype == got.dtype == np.float64
    _close(got, want, "train output, f64")
    stats = {k: v for k, v in net64.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert set(stats) == {k for k in moved
                          if k.endswith(("running_mean", "running_var"))}
    for name, v in stats.items():
        _close(v.numpy(), moved[name].numpy(), f"f64 running stat {name}")
    start = _port_sd(variables)
    name = "layer4.0.bn1.running_var"
    assert not np.allclose(stats[name].numpy(), start[name].numpy())

    jax32, _ = jax_net.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    ref_err = np.abs(np.asarray(jax32) - want).max()
    assert np.abs(got32 - want).max() <= 2 * ref_err, (
        np.abs(got32 - want).max(), ref_err)


def test_torchvision_key_names_and_shapes():
    """torchvision's ``resnet50`` state-dict names, so the reference's
    ``.pth`` loads with ``load_state_dict`` (fc is not part of the tower)."""
    net = ResNet(*ARCH_LAYERS["resnet50"])
    sd = net.state_dict()
    assert sd["conv1.weight"].shape == (64, 3, 7, 7)
    assert sd["layer1.0.downsample.0.weight"].shape == (256, 64, 1, 1)
    assert sd["layer1.0.downsample.1.running_var"].shape == (256,)
    assert sd["layer4.2.conv3.weight"].shape == (2048, 512, 1, 1)
    assert "layer2.1.downsample.0.weight" not in sd
    n_params = sum(p.numel() for p in net.parameters())
    assert n_params == 23_508_032  # torchvision's resnet50 less its fc
    assert sum(p.numel() for p in ResNet(
        *ARCH_LAYERS["resnet18"]).parameters()) == 11_176_512


def test_build_model_takes_the_torchvision_tower():
    """``baseline_gru_rn50_ls_bs128.yaml``'s tower builds, for serving and
    for training."""
    cfg = get_default_cfg()
    cfg.merge_from_file(os.path.join(
        REPO, "configs/cuhkpedes/baseline_gru_rn50_ls_bs128.yaml"))
    cfg.MODEL.GRU.VOCABULARY_SIZE = 50
    cfg.MODEL.NUM_CLASSES = 8
    for train in (False, True):
        model = build_model(cfg, "cpu", train=train)
        assert isinstance(model.visual_model, ResNet)
        assert model.visual_model.out_channels == 2048
        assert model.visual_model.layer4[0].conv2.stride == (1, 1)
        assert model.training == train
