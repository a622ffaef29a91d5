"""The port's bi-GRU against the JAX package, on the CPU in float32.

The fused scan's plain version (the CUDA kernel's contract) is held against
the JAX Pallas kernel in interpret mode and against its XLA definition, in
both pool modes; the port's ``BiGRUEncoder`` is held against the JAX
encoder on converted weights.  Tolerance atol/rtol 1e-5: both sides run the
same float32 arithmetic, in another summation order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_tpu.models.gru import BiGRUEncoder as JaxBiGRU
from textreid_tpu.ops.gru_pallas import _xla_pooled_forward
from textreid_tpu.ops.gru_pallas import bigru_pooled_scan as jax_bigru_pooled
from textreid_torch.models.gru import BiGRUEncoder, masked_max_pool, reverse_padded
from textreid_torch.ops.gru import bigru_pooled_scan, bigru_pooled_scan_plain
from textreid_torch.utils.weight_convert import _textual

torch.set_num_threads(2)

B, T, H = 4, 7, 16
LENGTHS = np.array([7, 3, 1, 5], np.int32)  # a full-length row, mixed others


@pytest.fixture(scope="module")
def gates():
    rng = np.random.RandomState(11)
    xf = rng.randn(B, T, 3 * H).astype(np.float32)
    xb = rng.randn(B, T, 3 * H).astype(np.float32)
    w_f = (rng.randn(H, 3 * H) * 0.3).astype(np.float32)
    w_b = (rng.randn(H, 3 * H) * 0.3).astype(np.float32)
    return xf, xb, w_f, w_b


@pytest.mark.parametrize("pool_mode", ["batch", "always"])
def test_fused_scan_matches_pallas_interpret(gates, pool_mode):
    xf, xb, w_f, w_b = gates
    want = np.asarray(jax_bigru_pooled(
        jnp.asarray(xf), jnp.asarray(xb), jnp.asarray(w_f), jnp.asarray(w_b),
        jnp.asarray(LENGTHS), interpret=True, pool_mode=pool_mode))
    got = bigru_pooled_scan(*map(torch.from_numpy, (xf, xb, w_f, w_b)),
                            torch.from_numpy(LENGTHS), pool_mode=pool_mode)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("pool_mode", ["batch", "always"])
def test_fused_scan_matches_xla_definition(gates, pool_mode):
    xf, xb, w_f, w_b = gates
    want = np.asarray(_xla_pooled_forward(
        jnp.swapaxes(xf, 0, 1), jnp.swapaxes(xb, 0, 1), jnp.asarray(w_f),
        jnp.asarray(w_b), jnp.asarray(LENGTHS), pool_mode))
    got = bigru_pooled_scan(*map(torch.from_numpy, (xf, xb, w_f, w_b)),
                            torch.from_numpy(LENGTHS), pool_mode=pool_mode)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_plain_scan_is_the_raw_masked_max(gates):
    """The kernel contract has no zero participation: a row's max runs over
    its valid steps only, so it can stay negative."""
    xf, xb, w_f, w_b = gates
    raw = bigru_pooled_scan_plain(*map(torch.from_numpy, (xf, xb, w_f, w_b)),
                                  torch.from_numpy(LENGTHS))
    pooled = bigru_pooled_scan(*map(torch.from_numpy, (xf, xb, w_f, w_b)),
                               torch.from_numpy(LENGTHS), pool_mode="always")
    assert (raw < 0).any()
    full = LENGTHS == T
    np.testing.assert_array_equal(raw[full].numpy(), pooled[full].numpy())
    np.testing.assert_array_equal(raw[~full].clamp_min(0).numpy(),
                                  pooled[~full].numpy())


def test_plain_scan_keeps_bf16_inputs(gates):
    xf, xb, w_f, w_b = (torch.from_numpy(a).bfloat16() for a in gates)
    out = bigru_pooled_scan_plain(xf, xb, w_f, w_b, torch.from_numpy(LENGTHS))
    assert out.dtype == torch.bfloat16 and out.shape == (B, 2 * H)


def test_helpers_match_jax():
    from textreid_tpu.models.gru import masked_max_pool as jax_pool
    from textreid_tpu.models.gru import reverse_padded as jax_rev

    x = np.random.RandomState(3).randn(B, T, 5).astype(np.float32)
    lens = torch.from_numpy(LENGTHS)
    np.testing.assert_array_equal(
        reverse_padded(torch.from_numpy(x), lens).numpy(),
        np.asarray(jax_rev(jnp.asarray(x), jnp.asarray(LENGTHS))))
    for mode in ("batch", "always"):
        np.testing.assert_array_equal(
            masked_max_pool(torch.from_numpy(x), lens, mode).numpy(),
            np.asarray(jax_pool(jnp.asarray(x), jnp.asarray(LENGTHS), mode)))


def _encoder_pair(use_onehot, num_layers=1, table_width=12):
    vocab, embed = 30, 8
    table = np.random.RandomState(5).randn(vocab, table_width).astype(
        np.float32)
    frozen = None if use_onehot == "yes" else table
    jax_enc = JaxBiGRU(hidden_dim=H, vocab_size=vocab, embed_size=embed,
                       num_layers=num_layers, use_onehot=use_onehot,
                       frozen_table_init=(lambda: table) if frozen is not None
                       else None)
    rng = np.random.RandomState(9)
    ids = rng.randint(1, vocab, (B, T)).astype(np.int32)
    variables = jax_enc.init(jax.random.PRNGKey(1), jnp.asarray(ids),
                             jnp.asarray(LENGTHS))
    want = np.asarray(jax_enc.apply(variables, jnp.asarray(ids),
                                    jnp.asarray(LENGTHS)))
    port = BiGRUEncoder(hidden_dim=H, vocab_size=vocab, embed_size=embed,
                        num_layers=num_layers, use_onehot=use_onehot,
                        frozen_table=frozen)
    sd = {}
    _textual(sd, "", jax.tree.map(np.asarray, variables["params"]))
    if frozen is not None:
        sd["frozen_token_table"] = np.asarray(
            variables["constants"]["frozen_token_table"])
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()})
    got = port(torch.from_numpy(ids), torch.from_numpy(LENGTHS))
    return got.detach().numpy(), want


@pytest.mark.parametrize("use_onehot,table_width", [
    ("yes", 12),        # learnable table
    ("clip_vit", 12),   # frozen table + embed_adapter (12 -> 8)
    ("clip_vit", 8),    # frozen table at the GRU input width, no adapter
])
def test_encoder_matches_jax(use_onehot, table_width):
    got, want = _encoder_pair(use_onehot, table_width=table_width)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_two_layer_encoder_matches_jax_on_cpu():
    got, want = _encoder_pair("yes", num_layers=2)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_missing_frozen_table_is_an_error():
    with pytest.raises(ValueError, match="frozen token table"):
        BiGRUEncoder(use_onehot="clip_vit")
