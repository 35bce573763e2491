"""Port parity for the DistilBERT trunk (CPU): ``fedrec_tpu_torch.models.bert``
against the JAX package's Flax trunk, from one Flax tree
(``params.from_flax``) or from one HuggingFace-layout checkpoint file that
the test writes (``.bin`` and ``.safetensors``), and the precompute against
a direct call.

Tolerances: the same f32 products summed in another order by XLA and
PyTorch. At small width (2 layers, dim 64) the token states agree within
atol 1e-5 / rtol 1e-5; at the full width of one layer (768 wide, FFN 3072,
30,522-row vocab), where the reductions are 12-48x longer, within 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fedrec_tpu.models import bert as jbert
from fedrec_tpu_torch.models import bert as tbert
from fedrec_tpu_torch.params import from_flax, init_params

SMALL = dict(vocab_size=97, max_position_embeddings=32, dim=64, n_layers=2, n_heads=4,
             hidden_dim=128, dropout=0.0, attention_dropout=0.0)


def _tokens(rng, n: int, L: int, vocab: int) -> np.ndarray:
    """(n, 2, L) ids and masks: row 0 all padding (news id 0's row), row 2
    padded after 5 tokens, the rest full."""
    tokens = np.zeros((n, 2, L), np.int64)
    tokens[:, 0] = rng.integers(0, vocab, size=(n, L))
    tokens[:, 1] = 1
    tokens[0] = 0
    tokens[2, 1, 5:] = 0
    tokens[2, 0, 5:] = 0
    return tokens


def _jax_trunk(cfg: dict, L: int, seed: int = 0):
    jcfg = jbert.DistilBertConfig(**cfg)
    params = jbert.init_trunk_params(jax.random.PRNGKey(seed), jcfg, title_len=L)
    return jcfg, jax.tree_util.tree_map(np.asarray, params)


def _jax_states(jcfg, params, tokens) -> np.ndarray:
    return np.asarray(jbert.DistilBert(jcfg).apply(
        {"params": params}, jnp.asarray(tokens[:, 0], jnp.int32),
        jnp.asarray(tokens[:, 1], jnp.int32)))


def _port_trunk(cfg: dict, params) -> tbert.DistilBert:
    trunk = tbert.DistilBert(tbert.DistilBertConfig(**cfg))
    from_flax(trunk, params)
    return trunk.eval()


def _port_states(trunk, tokens) -> np.ndarray:
    with torch.no_grad():
        t = torch.from_numpy(tokens)
        return trunk(t[:, 0], t[:, 1]).numpy()


def test_trunk_matches_jax_at_small_width(rng):
    """2 layers, dim 64, 4 heads, FFN 128, L=16, from ``from_flax`` of JAX's
    ``init_trunk_params``; the all-padding row attends uniformly in both."""
    L = 16
    jcfg, params = _jax_trunk(SMALL, L)
    trunk = _port_trunk(SMALL, params)
    assert len(from_flax(tbert.DistilBert(tbert.DistilBertConfig(**SMALL)), params)) == 3 + 2 * 8
    tokens = _tokens(rng, 6, L, SMALL["vocab_size"])
    np.testing.assert_allclose(_port_states(trunk, tokens), _jax_states(jcfg, params, tokens),
                               atol=1e-5, rtol=1e-5)


def test_trunk_matches_jax_at_full_width_one_layer(rng):
    """768 wide, 12 heads, FFN 3072, the 30,522-row vocab, one layer."""
    cfg = dict(tbert.DistilBertConfig().__dict__, n_layers=1, dropout=0.0,
               attention_dropout=0.0)
    L = 24
    jcfg, params = _jax_trunk(cfg, L)
    trunk = _port_trunk(cfg, params)
    tokens = _tokens(rng, 4, L, cfg["vocab_size"])
    np.testing.assert_allclose(_port_states(trunk, tokens), _jax_states(jcfg, params, tokens),
                               atol=1e-4)


def test_trunk_matches_huggingface_distilbert(rng):
    """The reference's own trunk (HF ``DistilBertModel``, random weights at
    small width) through ``convert_hf_state_dict``: no transpose anywhere."""
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.DistilBertConfig(
        vocab_size=SMALL["vocab_size"], max_position_embeddings=SMALL["max_position_embeddings"],
        dim=SMALL["dim"], n_layers=SMALL["n_layers"], n_heads=SMALL["n_heads"],
        hidden_dim=SMALL["hidden_dim"], dropout=0.0, attention_dropout=0.0)
    torch.manual_seed(0)
    hf = transformers.DistilBertModel(hf_cfg).eval()
    trunk = tbert.DistilBert(tbert.DistilBertConfig(**SMALL))
    trunk.load_state_dict(tbert.convert_hf_state_dict(hf.state_dict(),
                                                      tbert.DistilBertConfig(**SMALL)))
    tokens = _tokens(rng, 5, 12, SMALL["vocab_size"])[1:]  # HF gives NaN on all-padding rows
    with torch.no_grad():
        want = hf(input_ids=torch.from_numpy(tokens[:, 0]),
                  attention_mask=torch.from_numpy(tokens[:, 1])).last_hidden_state.numpy()
    np.testing.assert_allclose(_port_states(trunk.eval(), tokens), want, atol=2e-5)


def _hf_state_dict(cfg: dict, seed: int = 0) -> dict:
    """A random state_dict under HuggingFace DistilBERT's names and layouts."""
    g = torch.Generator().manual_seed(seed)
    d, f = cfg["dim"], cfg["hidden_dim"]
    sd = {"embeddings.word_embeddings.weight": (cfg["vocab_size"], d),
          "embeddings.position_embeddings.weight": (cfg["max_position_embeddings"], d),
          "embeddings.LayerNorm.weight": (d,), "embeddings.LayerNorm.bias": (d,)}
    for i in range(cfg["n_layers"]):
        p = f"transformer.layer.{i}"
        for lin in ("q_lin", "k_lin", "v_lin", "out_lin"):
            sd[f"{p}.attention.{lin}.weight"], sd[f"{p}.attention.{lin}.bias"] = (d, d), (d,)
        for ln in ("sa_layer_norm", "output_layer_norm"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = (d,), (d,)
        sd[f"{p}.ffn.lin1.weight"], sd[f"{p}.ffn.lin1.bias"] = (f, d), (f,)
        sd[f"{p}.ffn.lin2.weight"], sd[f"{p}.ffn.lin2.bias"] = (d, f), (d,)
    return {k: torch.randn(shape, generator=g) * 0.2 for k, shape in sd.items()}


@pytest.mark.parametrize("fmt", [".bin", ".safetensors"])
@pytest.mark.parametrize("prefixed", [False, True], ids=["bare", "distilbert_prefix"])
def test_hf_checkpoint_loads_into_both_packages_alike(tmp_path, rng, fmt, prefixed):
    """One HF-layout checkpoint file, written here, through each package's
    ``load_hf_state_dict``: the two trunks give equal states."""
    from safetensors.torch import save_file

    sd = _hf_state_dict(SMALL)
    if prefixed:
        sd = {f"distilbert.{k}": v for k, v in sd.items()}
    path = tmp_path / f"model{fmt}"
    if fmt == ".bin":
        torch.save(sd, path)
    else:
        save_file(sd, str(path))
    cfg = tbert.DistilBertConfig(**SMALL)
    port_sd = tbert.load_hf_state_dict(str(path), cfg)
    trunk = tbert.DistilBert(cfg)
    trunk.load_state_dict(port_sd)
    jcfg = jbert.DistilBertConfig(**SMALL)
    jparams = jbert.load_hf_state_dict(str(path), jcfg)
    tokens = _tokens(rng, 5, 12, SMALL["vocab_size"])
    np.testing.assert_allclose(_port_states(trunk.eval(), tokens),
                               _jax_states(jcfg, jparams, tokens), atol=1e-5, rtol=1e-5)
    # (out, in) kept: the port's q_lin weight is HF's tensor, untransposed
    key = ("distilbert." if prefixed else "") + "transformer.layer.1.attention.q_lin.weight"
    assert torch.equal(port_sd["layer_1.attention.q_lin.weight"], sd[key])


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16, torch.float32])
def test_safetensors_reader_reads_half_types_exactly(tmp_path, dtype):
    from safetensors.torch import save_file

    g = torch.Generator().manual_seed(1)
    sd = {"a": torch.randn((3, 5), generator=g).to(dtype), "b": torch.randn((7,), generator=g).to(dtype),
          "ids": torch.arange(4, dtype=torch.int64)}
    save_file(sd, str(tmp_path / "m.safetensors"), metadata={"format": "pt"})
    got = tbert.read_safetensors(tmp_path / "m.safetensors")
    assert set(got) == set(sd)
    for k, v in sd.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)


def test_precompute_token_states_equals_a_direct_call(rng):
    """13 titles in chunks of 4 (a ragged last chunk) into one host array:
    equal to one direct call of the trunk, and within 1e-5 of JAX's
    ``precompute_token_states`` on the same weights."""
    L = 10
    jcfg, params = _jax_trunk(SMALL, L)
    trunk = _port_trunk(SMALL, params)
    tokens = _tokens(rng, 13, L, SMALL["vocab_size"])
    states = tbert.precompute_token_states(trunk, tokens, trunk.cfg, chunk=4, device="cpu")
    assert states.shape == (13, L, SMALL["dim"]) and states.dtype == np.float32
    np.testing.assert_allclose(states, _port_states(trunk, tokens), rtol=1e-6, atol=1e-6)
    want = jbert.precompute_token_states(params, tokens, jcfg, chunk=4)
    np.testing.assert_allclose(states, want, atol=1e-5, rtol=1e-5)
    # a state dict does as well as the module
    again = tbert.precompute_token_states(trunk.state_dict(), tokens, trunk.cfg, chunk=5,
                                          device="cpu")
    np.testing.assert_array_equal(again, states)


def test_precompute_refuses_bfloat16_and_out_of_vocab_ids():
    cfg = tbert.DistilBertConfig(**SMALL)
    tokens = np.zeros((2, 2, 4), np.int64)
    sd = tbert.init_trunk_params(0, cfg)
    with pytest.raises(ValueError, match="no bfloat16"):
        tbert.precompute_token_states(sd, tokens, cfg, dtype="bfloat16", device="cpu")
    tokens[1, 0, 0] = SMALL["vocab_size"]
    with pytest.raises(ValueError, match="vocab_size"):
        tbert.precompute_token_states(sd, tokens, cfg, device="cpu")


def test_text_encoder_matches_jax_and_remat_changes_nothing(rng):
    """The whole text tower (trunk + additive head, no token mask) from one
    Flax tree: (B, C, 2, L) tokens to (B, C, news_dim) vectors within 1e-5
    of JAX's; its gradients reach the trunk, and are the same with
    ``remat`` on and off (bitwise), trunk dropout included."""
    L, news_dim = 10, 16
    jcfg = jbert.DistilBertConfig(**SMALL)
    jenc = jbert.TextEncoder(trunk_cfg=jcfg, news_dim=news_dim, remat=True)
    tokens = _tokens(rng, 6, L, SMALL["vocab_size"]).reshape(2, 3, 2, L)
    variables = jenc.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    want = np.asarray(jenc.apply({"params": params}, jnp.asarray(tokens)))

    enc = tbert.TextEncoder(tbert.DistilBertConfig(**SMALL), news_dim=news_dim, remat=True)
    loaded = from_flax(enc, params)
    assert {p.split(".")[0] for p in loaded} == {"trunk", "head"}
    got = enc(torch.from_numpy(tokens))
    assert got.shape == (2, 3, news_dim)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5, rtol=1e-5)

    drop = dict(SMALL, dropout=0.1, attention_dropout=0.1)
    grads = []
    for remat in (True, False):
        enc2 = tbert.TextEncoder(tbert.DistilBertConfig(**drop), news_dim=news_dim, remat=remat)
        enc2.load_state_dict(enc.state_dict())
        out = enc2(torch.from_numpy(tokens), True, torch.Generator().manual_seed(5))
        (out ** 2).sum().backward()
        grads.append([p.grad for p in enc2.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    trunk_grads = grads[0][:len(list(enc.trunk.parameters()))]
    assert all(torch.isfinite(g).all() for g in trunk_grads)
    assert float(sum(g.norm() for g in trunk_grads)) > 0


def test_init_trunk_params_has_the_converted_layout():
    """Seeded Flax-default initialisation, keyed like ``convert_hf_state_dict``'s
    output: unit LayerNorm scales, zero biases, embedding tables of std
    sqrt(1/dim) (truncated normal)."""
    cfg = tbert.DistilBertConfig(**SMALL)
    sd = tbert.init_trunk_params(3, cfg)
    hf = tbert.convert_hf_state_dict(_hf_state_dict(SMALL), cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in hf.items()}
    assert torch.equal(sd["layer_0.sa_layer_norm.weight"], torch.ones(SMALL["dim"]))
    assert not sd["layer_1.lin1.bias"].any()
    std = float(sd["word_embeddings.weight"].std())
    assert abs(std - (1 / SMALL["dim"]) ** 0.5) < 0.1 * (1 / SMALL["dim"]) ** 0.5
    assert all(torch.equal(a, b) for a, b in zip(sd.values(),
                                                  tbert.init_trunk_params(3, cfg).values()))
    model = init_params(tbert.DistilBert(cfg), seed=3)
    assert torch.equal(model.state_dict()["word_embeddings.weight"], sd["word_embeddings.weight"])
