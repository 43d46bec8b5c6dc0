"""The port's Wave-U-Net (``nomad_tpu_torch.models.waveunet``) and its
weight bridge against the JAX package's, on the CPU at n_layers 3 and
channel interval 4: the x2 interpolation, eval and train mode (with flax's
running-statistics update, which stock ``nn.BatchNorm1d`` does not make),
and the bridge both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from nomad_tpu.api import _flatten, _unflatten
from nomad_tpu.models.waveunet import WaveUNet as JaxWaveUNet
from nomad_tpu.models.waveunet import interpolate_linear_x2 as jax_interpolate
from nomad_tpu_torch.convert import jax_to_waveunet, waveunet_to_jax
from nomad_tpu_torch.models import WaveUNet, interpolate_linear_x2

torch.set_num_threads(2)
N_LAYERS, CI, T = 3, 4, 256


@pytest.mark.parametrize("t", [1, 2, 8, 33])
def test_interpolate_linear_x2_matches_jax(t):
    x = np.random.default_rng(t).standard_normal((2, 3, t)).astype(np.float32)
    ours = interpolate_linear_x2(torch.from_numpy(x)).numpy()
    theirs = np.asarray(jax_interpolate(jnp.asarray(x.transpose(0, 2, 1)))).transpose(0, 2, 1)
    assert ours.shape == (2, 3, 2 * t)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jax_net():
    """The JAX U-Net, its init with running statistics moved off 0/1 (so
    that eval mode reads them), a jitted eval apply and the train apply
    op by op: jitted, XLA's fusions put the train-mode output 1.1e-5 off an
    f64 run, the op-by-op apply and the port 1.1e-6
    (``scripts/se_precision_probe.py``)."""
    net = JaxWaveUNet(n_layers=N_LAYERS, channels_interval=CI)
    init = jax.jit(lambda k, x: net.init(k, x, train=False))(
        jax.random.key(0), jnp.zeros((1, T), jnp.float32))
    flat = _flatten(jax.tree_util.tree_map(np.asarray, init))
    rng = np.random.default_rng(3)
    for k in flat:
        if k.endswith("/mean"):
            flat[k] = (0.1 * rng.standard_normal(flat[k].shape)).astype(np.float32)
        elif k.endswith("/var"):
            flat[k] = rng.uniform(0.5, 2.0, flat[k].shape).astype(np.float32)
    apply_eval = jax.jit(lambda v, x: net.apply(v, x, train=False))

    def apply_train(v, x):
        return net.apply(v, x, train=True, mutable=["batch_stats"])

    return flat, apply_eval, apply_train


def port_net(flat) -> WaveUNet:
    net = WaveUNet(n_layers=N_LAYERS, channels_interval=CI)
    net.load_state_dict(jax_to_waveunet(flat), strict=True)
    return net


def wave(shape, seed=1):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, T), (2, 1, T)], ids=["B_T", "B_1_T"])
def test_eval_mode_matches_jax(jax_net, shape):
    flat, apply_eval, _ = jax_net
    x = wave(shape)
    net = port_net(flat).eval()
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    theirs = np.asarray(apply_eval(_unflatten(flat), jnp.asarray(x)))
    assert ours.shape == theirs.shape == shape
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=2e-5)


def stock_batchnorm_copy(net: WaveUNet) -> WaveUNet:
    """The same network with torch's own ``nn.BatchNorm1d`` (momentum 0.1,
    the same parameters and running statistics) in every level."""
    for mod in list(net.modules()):
        if hasattr(mod, "bn"):
            stock = nn.BatchNorm1d(mod.bn.weight.numel(), eps=1e-5, momentum=0.1)
            with torch.no_grad():
                stock.weight.copy_(mod.bn.weight)
                stock.bias.copy_(mod.bn.bias)
                stock.running_mean.copy_(mod.bn.mean)
                stock.running_var.copy_(mod.bn.var)
            mod.bn = stock
    return net


def test_train_mode_output_and_running_statistics_match_flax(jax_net):
    """Batch statistics normalise, and the running ones move as flax moves
    them: ra = 0.9 ra + 0.1 var with the biased variance. Stock
    ``nn.BatchNorm1d`` would update the variance with the unbiased one
    (n/(n-1): 1.6 % at the middle level's n = 64), beyond the tolerance."""
    flat, _, apply_train = jax_net
    x = wave((2, T), seed=2)
    out, mutated = apply_train(_unflatten(flat), jnp.asarray(x))
    want = _flatten({"batch_stats": jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])})
    net = port_net(flat).train()
    with torch.no_grad():
        ours = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(out), rtol=0, atol=1e-5)
    got = waveunet_to_jax(net.state_dict())
    assert len(want) == 2 * (2 * N_LAYERS + 1)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)
        assert not np.array_equal(value, flat[key]), key  # the step moved them

    stock = stock_batchnorm_copy(port_net(flat)).train()
    with torch.no_grad():
        stock(torch.from_numpy(x))
    stock_var = {name: m.running_var for name, m in stock.named_modules()
                 if isinstance(m, nn.BatchNorm1d)}
    worst = max(np.abs(v.numpy() - want[f"batch_stats/{name.replace('.', '/')}/var"]).max()
                for name, v in stock_var.items())
    assert worst > 1e-5


def test_bridge_round_trip_is_bit_equal(jax_net):
    flat, _, _ = jax_net
    back = waveunet_to_jax(port_net(flat).state_dict())
    assert sorted(back) == sorted(flat)
    for k, v in flat.items():
        assert back[k].dtype == np.float32 and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v)
    with pytest.raises(KeyError):
        jax_to_waveunet({"opt_state/down_0/conv/kernel": flat["params/down_0/conv/kernel"]})


def test_seeded_init_is_lecun_normal_with_zero_biases():
    net = WaveUNet(n_layers=N_LAYERS, channels_interval=CI)
    again = WaveUNet(n_layers=N_LAYERS, channels_interval=CI)
    for (name, p), q in zip(net.state_dict().items(), again.state_dict().values()):
        assert torch.equal(p, q), name  # seeded: the same bits every time
        if name.endswith("conv.weight"):
            fan_in = p[0].numel()
            assert p.abs().max() <= 2 * (1 / fan_in) ** 0.5 / 0.8796 + 1e-6
            assert p.std() > 0.5 * (1 / fan_in) ** 0.5
        elif name.endswith(("conv.bias", "bn.bias", "bn.mean")):
            assert not p.any(), name
        elif name.endswith(("bn.weight", "bn.var")):
            assert torch.equal(p, torch.ones_like(p)), name
