"""The port's one-direction GRU scan (K3's contract) and the multi-layer
bi-GRU built from it, against the JAX package on the CPU in float32.

``gru_scan_plain`` is held against the JAX Pallas kernel ``gru_scan_pallas``
in interpret mode (H=128, the kernel's lane width) and against the lax scan
``models.gru.gru_scan`` (H=16 and 128, both scan orders, non-zero ``h0``);
the autograd Function's gradient (its launcher swapped for the plain
forward: there is no card here) against ``jax.vjp`` of ``_xla_scan_forward``,
the definition the JAX custom VJP differentiates.  A 2-layer ``BiGRUEncoder``
is held against the JAX encoder on weights carried over by
``state_dict_from_jax``, on one ragged batch, under both pool rules.
Tolerance atol 1e-5: the same float32 arithmetic in another summation
order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models.gru import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models.gru import gru_scan as jax_gru_scan
from textreid_tpu.ops.gru_pallas import _xla_scan_forward, gru_scan_pallas
from textreid_torch.models.gru import BiGRUEncoder, masked_max_pool, reverse_padded
from textreid_torch.ops import gru
from textreid_torch.utils.weight_convert import _textual

torch.set_num_threads(2)

T, B = 7, 5


def _inputs(hidden, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, 3 * hidden).astype(np.float32)
    w = (rng.randn(hidden, 3 * hidden) / np.sqrt(hidden)).astype(np.float32)
    h0 = (rng.randn(B, hidden) * 0.5).astype(np.float32)
    return x, w, h0


def _plain(x, w, h0, reverse=False):
    return gru.gru_scan(*map(torch.from_numpy, (x, w, h0)),
                        reverse=reverse).numpy()


def test_plain_scan_matches_pallas_interpret():
    x, w, h0 = _inputs(128)
    want = gru_scan_pallas(jnp.swapaxes(jnp.asarray(x), 0, 1), jnp.asarray(w),
                           jnp.asarray(h0), interpret=True)
    np.testing.assert_allclose(_plain(x, w, h0),
                               np.swapaxes(np.asarray(want), 0, 1), atol=1e-5)


@pytest.mark.parametrize("hidden", [16, 128])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_scan_matches_lax_scan(hidden, reverse):
    x, w, h0 = _inputs(hidden, seed=hidden)
    want = jax_gru_scan(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h0),
                        reverse=reverse)
    np.testing.assert_allclose(_plain(x, w, h0, reverse), np.asarray(want),
                               atol=1e-5)


def test_plain_scan_rounds_only_its_output():
    """bf16 in, bf16 out, float32 inside: what the kernel does."""
    x, w, h0 = (torch.from_numpy(a) for a in _inputs(16))
    got = gru.gru_scan_plain(x.bfloat16(), w.bfloat16(), h0.bfloat16())
    want = gru.gru_scan_plain(x.bfloat16().float(), w.bfloat16().float(),
                              h0.bfloat16().float())
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, 16)
    torch.testing.assert_close(got, want.bfloat16(), atol=0, rtol=0)


@pytest.mark.parametrize("reverse", [False, True])
def test_function_has_the_gradient_of_the_xla_scan(monkeypatch, reverse):
    launched = []

    def launcher(x_gates, w_h, h0, rev):
        out = gru.gru_scan_plain(x_gates, w_h, h0, rev)
        launched.append(out.grad_fn)
        return out

    monkeypatch.setattr(gru, "_gru_scan_cuda", launcher)
    x, w, h0 = _inputs(16, seed=3)
    g = np.random.RandomState(4).randn(B, T, 16).astype(np.float32)
    leaves = [torch.from_numpy(a.copy()).requires_grad_(True)
              for a in (x, w, h0)]
    out = gru._GruScan.apply(*leaves, reverse)
    assert launched == [None] and out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))

    def definition(x_tbg, w_h, h_init):  # time-major, front to back
        if reverse:
            return _xla_scan_forward(x_tbg[::-1], w_h, h_init)[::-1]
        return _xla_scan_forward(x_tbg, w_h, h_init)

    ys, vjp = jax.vjp(definition, jnp.swapaxes(jnp.asarray(x), 0, 1),
                      jnp.asarray(w), jnp.asarray(h0))
    np.testing.assert_allclose(out.detach().numpy(),
                               np.swapaxes(np.asarray(ys), 0, 1), atol=1e-5)
    dx, dw, dh0 = vjp(jnp.swapaxes(jnp.asarray(g), 0, 1))
    want = (np.swapaxes(np.asarray(dx), 0, 1), np.asarray(dw),
            np.asarray(dh0))
    for name, a, b in zip(("x_gates", "w_h", "h0"), got, want):
        assert np.abs(b).sum() > 0, name
        np.testing.assert_allclose(a.numpy(), b, atol=1e-5, err_msg=name)


def test_cuda_entry_refuses_cpu_tensors_and_bad_shapes():
    x, w, h0 = (torch.from_numpy(a) for a in _inputs(32))
    with pytest.raises(ValueError, match="must be on"):
        gru._gru_scan_cuda(x, w, h0, False)
    with pytest.raises(ValueError, match="H % 32"):
        gru._gru_scan_cuda(*(torch.from_numpy(a) for a in _inputs(16)), False)
    with pytest.raises(ValueError, match="h0 must be"):
        gru._gru_scan_cuda(x, w, h0[:2], False)


LENGTHS = np.array([7, 3, 1, 5, 6], np.int32)


@pytest.fixture(scope="module")
def two_layer_pair():
    """(jax encoder, its variables, the port's encoder with the same
    weights, token ids)."""
    hidden, vocab, embed = 16, 30, 8
    table = np.random.RandomState(5).randn(vocab, 12).astype(np.float32)
    rng = np.random.RandomState(9)
    ids = rng.randint(1, vocab, (B, T)).astype(np.int32)
    jax_enc = JaxBiGRU(hidden_dim=hidden, vocab_size=vocab, embed_size=embed,
                       num_layers=2, use_onehot="clip_vit",
                       frozen_table_init=lambda: table)
    variables = jax_enc.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                             jnp.asarray(LENGTHS))
    port = BiGRUEncoder(hidden_dim=hidden, vocab_size=vocab, embed_size=embed,
                        num_layers=2, use_onehot="clip_vit",
                        frozen_table=table).eval()
    sd = {"frozen_token_table": table}
    _textual(sd, "", jax.tree.map(np.asarray, variables["params"]))
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    return jax_enc, variables, port, ids


def test_two_layer_weights_carry_over(two_layer_pair):
    _, variables, port, _ = two_layer_pair
    params = variables["params"]
    sd = port.state_dict()
    assert sd["gru.weight_ih_l1"].shape == (48, 32)  # layer-1 input is 2H
    assert sd["gru.weight_hh_l1_reverse"].shape == (48, 16)
    for src, dst in (("fwd_w_ih_l1", "gru.weight_ih_l1"),
                     ("bwd_w_hh_l1", "gru.weight_hh_l1_reverse"),
                     ("bwd_w_ih_l0", "gru.weight_ih_l0_reverse")):
        np.testing.assert_array_equal(sd[dst].numpy(),
                                      np.asarray(params[src]).T)


@pytest.mark.parametrize("pool_mode", ["batch", "always"])
def test_two_layer_encoder_matches_jax(two_layer_pair, pool_mode):
    jax_enc, variables, port, ids = two_layer_pair
    want = jax_enc.clone(pool_mode=pool_mode).apply(
        variables, jnp.asarray(ids), jnp.asarray(LENGTHS))
    got = port(torch.from_numpy(ids), torch.from_numpy(LENGTHS),
               pool_mode=pool_mode)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)


def test_fused_last_layer_equals_the_pooled_plain_layers(two_layer_pair):
    """The encoder's last layer is the fused scan with pooling; scanning it
    per direction and max-pooling afterwards (the JAX ``use_pallas=False``
    composition) gives the same embedding."""
    _, _, port, ids = two_layer_pair
    lens = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        x = port.embed_tokens(torch.from_numpy(ids))
        h0 = x.new_zeros(B, port.hidden_dim)
        layer_in = x
        for layer in range(2):
            def scan(inputs, suffix):
                w_ih = getattr(port.gru, f"weight_ih_l{layer}{suffix}")
                w_hh = getattr(port.gru, f"weight_hh_l{layer}{suffix}")
                return gru.gru_scan_plain(inputs @ w_ih.T, w_hh.T, h0)
            out_b = reverse_padded(scan(reverse_padded(layer_in, lens),
                                        "_reverse"), lens)
            layer_in = torch.cat([scan(layer_in, ""), out_b], dim=-1)
        want = masked_max_pool(layer_in, lens, "batch")
        got = port(torch.from_numpy(ids), lens)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_multi_layer_tower_in_training_computes_its_eval_output(
        two_layer_pair):
    """The 2-layer yaml's ``DROPOUT_KEEP_PROB: 0.7`` is never applied: in
    train mode the port's tower computes its eval output, as the JAX
    step's does (its ``encode_text`` leaves ``deterministic`` at True, so
    that dropout never runs); atol 1e-5 against the JAX encoder so
    called."""
    jax_enc, variables, port, ids = two_layer_pair
    lens = torch.from_numpy(LENGTHS)
    with torch.no_grad():
        want = port.eval()(torch.from_numpy(ids), lens)
        got = port.train()(torch.from_numpy(ids), lens)
        port.eval()
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    ref = np.asarray(jax_enc.apply(variables, jnp.asarray(ids),
                                   jnp.asarray(LENGTHS)))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
