"""Port parity for sequence parallelism (CPU): ``parallel/ring.py``'s ring
and Ulysses attention and seq-sharded pool, the seq ``UserEncoder`` and the
joint and finetune train steps at ``fed.seq_shards = 4``, against the JAX
package and against the unsharded computation.

The port's side runs in one gloo world of 4 CPU processes (each rank holds
columns ``[4r, 4r + 4)`` of a 16-click history), started once for the module
by ``seq_world``; every rank saves its results and the tests compare them
here. The JAX side runs ``shard_map`` on 4 of the 8 host devices that
``tests/conftest.py`` gives it (the fed steps on a 2 clients x 4 seq mesh),
in this process. The ranks import nothing of JAX: this module imports JAX
inside the functions that use it.

Tolerances are the JAX package's own seq-vs-dense bars
(``tests/test_seq_parallel.py``): outputs 1e-5, gradients 2e-4, parameters
after Adam 2e-3 (Adam's g / (sqrt(v) + eps) amplifies the reduction-order
noise of near-zero gradients).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

SEQ = 4
B, L, H, D = 2, 16, 4, 8
ROOT = Path(__file__).resolve().parents[1]
_SMALL = dict(news_dim=32, num_heads=4, head_dim=8, query_dim=16)


# ------------------------------------------------------------ the inputs
def _attn_inputs():
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((B, L, H, D)).astype(np.float32) for _ in range(3))
    mask = np.ones((B, L), np.float32)
    mask[:, -3:] = 0.0
    mask[1, 5] = 0.0  # a padded key inside another rank's block
    return q, k, v, mask


def _pool_inputs():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, L, D)).astype(np.float32)
    logits = rng.standard_normal((3, L)).astype(np.float32)
    mask = np.ones((3, L), np.float32)
    mask[:, -5:] = 0.0
    return x, logits, mask


def _step_batch(seed: int, num_news: int = 32):
    rng = np.random.default_rng(seed)
    return {"candidates": rng.integers(0, num_news, (2, 4, 5)).astype(np.int32),
            "history": rng.integers(0, num_news, (2, 4, L)).astype(np.int32),
            "labels": np.zeros((2, 4), np.int32)}


def _overflow_batch():
    # only rank 3's history slice holds more distinct ids than the cap
    history = np.full((2, 4, L), 2, np.int32)
    history[:, :, 12:16] = np.arange(3, 19, dtype=np.int32).reshape(4, 4)[None]
    return {"candidates": np.full((2, 4, 5), 1, np.int32), "history": history,
            "labels": np.zeros((2, 4), np.int32)}


def _sets(mode: str, seq: int, *extra: str) -> list[str]:
    base = [f"model.{k}={v}" for k, v in _SMALL.items()] + [
        "model.dropout_rate=0.0", f"data.max_his_len={L}", "data.max_title_len=8",
        "data.batch_size=4", "fed.num_clients=2", f"fed.seq_shards={seq}", "fed.strategy=grad_avg",
        "optim.user_lr=1e-3", "optim.news_lr=1e-3"]
    if mode == "head":
        base += ["model.text_encoder_mode=head", "model.bert_hidden=48"]
    else:
        base += ["model.text_encoder_mode=finetune", "model.bert_hidden=32",
                 "model.trunk_layers=1", "model.trunk_heads=2", "model.trunk_ffn=64",
                 "model.trunk_vocab=500", "model.trunk_dropout=0.0"]
    return base + list(extra)


# ------------------------------------------------------- the ranks' side
def _port_step(params: dict, sets: list[str], table: np.ndarray, batches: list, group) -> dict:
    """``build_fed_train_step`` from the bridged tree over ``batches``:
    losses, overflow, client 0's parameters (Flax layout) after each step
    (``trees``) and after the last (``user``, ``news``)."""
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import from_flax, to_flax
    from fedrec_tpu_torch.parallel.mesh import shard_fed_batch
    from fedrec_tpu_torch.train import build_fed_train_step, init_client_state, replicate_state

    cfg = ExperimentConfig().apply_overrides(sets)
    model = NewsRecommender(cfg.model)
    from_flax(model.user_encoder, params["user"])
    from_flax(model.news_tower, params["news"])
    states = replicate_state(init_client_state(model, cfg, 0), 2, 1)
    step = build_fed_train_step(model, cfg, get_strategy(cfg.fed.strategy), device="cpu",
                                seq_group=group if cfg.fed.seq_shards > 1 else None)
    t = torch.from_numpy(table)
    losses, overflow, trees = [], [], []
    for b in batches:
        states, met = step(states, shard_fed_batch(b, group if cfg.fed.seq_shards > 1 else None), t)
        losses.append(met["loss"].numpy().copy())
        overflow.append(met["unique_overflow"])
        m = states[0].model
        trees.append({"user": to_flax(m.user_encoder), "news": to_flax(m.news_tower)})
    return {"losses": np.stack(losses), "overflow": overflow, "trees": trees, **trees[-1],
            "rng": states[0].generator.get_state().numpy()}


def _rank_main(rank: int, size: int, address: str, inputs: str, out: str) -> None:
    """One rank of the test world: every port-side computation of the module."""
    torch.set_num_threads(1)
    from fedrec_tpu_torch.models.encoders import UserEncoder
    from fedrec_tpu_torch.params import from_flax
    from fedrec_tpu_torch.parallel.multihost import initialize_distributed
    from fedrec_tpu_torch.parallel.ring import (
        SeqGroup,
        ring_attention,
        seq_parallel_pool,
        ulysses_attention,
    )

    world = initialize_distributed(address, size, rank)
    g = SeqGroup(world.rank, world.size, world.pg)
    inp = torch.load(inputs, weights_only=False)
    cols = slice(rank * L // size, (rank + 1) * L // size)
    res: dict = {}

    q, k, v, mask = (torch.from_numpy(a) for a in _attn_inputs())
    for name, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        for masked in (True, False):
            leaves = [t[:, cols].clone().requires_grad_() for t in (q, k, v)]
            o = fn(*leaves, mask[:, cols] if masked else None, g)
            # the world's loss is the sum of the ranks' sum(o^2)
            grads = torch.autograd.grad(o.square().sum(), leaves)
            res[f"attn/{name}/{masked}"] = (o.detach().numpy(), [x.numpy() for x in grads])

    x, logits, pmask = (torch.from_numpy(a) for a in _pool_inputs())
    res["pool/masked"] = seq_parallel_pool(x[:, cols], logits[:, cols], pmask[:, cols], g).numpy()
    res["pool/maskless"] = seq_parallel_pool(x[:, cols], logits[:, cols], None, g).numpy()

    clicked, umask = (torch.from_numpy(a) for a in inp["ue"]["inputs"])
    for impl in ("ring", "ulysses"):
        enc = UserEncoder(**_SMALL, seq_group=g, seq_impl=impl)
        from_flax(enc, inp["ue"]["params"])
        u = enc(clicked[:, cols], umask[:, cols])
        params = list(enc.parameters())
        grads = torch.autograd.grad(u.square().mean(), params)
        total = g.sum(torch.cat([x.reshape(-1) for x in grads]))
        res[f"ue/{impl}"] = (u.detach().numpy(),
                             [v.view_as(p).numpy() for v, p in
                              zip(total.split([p.numel() for p in params]), params)],
                             [n for n, _ in enc.named_parameters()])

    j = inp["joint"]
    res["joint/sgd"] = _port_step(j["params"], _sets("head", 4, "optim.optimizer=sgd",
                                                    "optim.user_lr=1", "optim.news_lr=1"),
                                  j["table"], j["batches"][:1], g)
    res["joint/adam"] = _port_step(j["params"], _sets("head", 4), j["table"], j["batches"], g)
    res["joint/ulysses"] = _port_step(j["params"], _sets("head", 4, "fed.seq_impl=ulysses"),
                                      j["table"], j["batches"], g)
    res["joint/dropout"] = _port_step(j["params"], _sets("head", 4, "model.dropout_rate=0.2"),
                                      j["table"], j["batches"], g)
    res["joint/overflow"] = _port_step(j["params"], _sets("head", 4, "data.unique_news_cap=6"),
                                       j["table"], [_overflow_batch()], g)
    f = inp["finetune"]
    res["finetune/adam"] = _port_step(f["params"], _sets("finetune", 4), f["table"],
                                      f["batches"], g)
    res["finetune/sgd"] = _port_step(f["params"], _sets("finetune", 4, "optim.optimizer=sgd",
                                                       "optim.user_lr=1", "optim.news_lr=1"),
                                     f["table"], f["batches"][:1], g)
    res["finetune/dropout"] = _port_step(f["params"], _sets("finetune", 4, "model.dropout_rate=0.2",
                                                           "model.trunk_dropout=0.2"),
                                         f["table"], f["batches"], g)
    res["finetune/cand_encode"] = _cand_encode(f, g)
    res["stats"] = g.stats
    torch.save(res, out)


def _cand_encode(f: dict, group) -> np.ndarray:
    """The finetune step's candidate encode at trunk dropout 0.2 with the
    same stream on every rank (the step's ``_encode_tokens_rows``)."""
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.params import from_flax
    from fedrec_tpu_torch.train.step import _encode_tokens_rows

    cfg = ExperimentConfig().apply_overrides(_sets("finetune", 4, "model.trunk_dropout=0.2"))
    model = NewsRecommender(cfg.model)
    from_flax(model.news_tower, f["params"]["news"])
    gen = torch.Generator().manual_seed(5)
    cand = torch.from_numpy(f["batches"][0]["candidates"][0]).long()
    return _encode_tokens_rows(model.text_encoder, torch.from_numpy(f["table"]).long(), cand,
                               gen).detach().numpy()


# ------------------------------------------------------------ the JAX side
def _jax_mesh():
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:SEQ]), ("seq",))


def _jax_cfg(mode: str, seq: int, **over):
    from fedrec_tpu.config import ExperimentConfig

    cfg = ExperimentConfig()
    for key, val in _SMALL.items():
        setattr(cfg.model, key, val)
    cfg.model.dropout_rate = 0.0
    cfg.data.max_his_len, cfg.data.max_title_len, cfg.data.batch_size = L, 8, 4
    cfg.fed.num_clients, cfg.fed.seq_shards = 2, seq
    cfg.optim.user_lr = cfg.optim.news_lr = 1e-3
    if mode == "head":
        cfg.model.text_encoder_mode, cfg.model.bert_hidden = "head", 48
    else:
        cfg.model.text_encoder_mode, cfg.model.bert_hidden = "finetune", 32
        cfg.model.trunk_layers, cfg.model.trunk_heads, cfg.model.trunk_ffn = 1, 2, 64
        cfg.model.trunk_vocab, cfg.model.trunk_dropout = 500, 0.0
    for path, val in over.items():
        sec, key = path.split("__")
        setattr(getattr(cfg, sec), key, val)
    return cfg


def _jax_state(cfg, num_news: int):
    import jax
    from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
    from fedrec_tpu.train.state import init_client_state, replicate_state

    model = JaxNewsRecommender(cfg.model)
    state0 = init_client_state(model, cfg, jax.random.PRNGKey(0), num_news, 8)
    return model, replicate_state(state0, 2, jax.random.PRNGKey(1))


def _client0(stacked) -> dict:
    import jax

    take = lambda tree: jax.tree_util.tree_map(lambda x: np.asarray(x[0]), tree)  # noqa: E731
    return {"user": take(stacked.user_params), "news": take(stacked.news_params)}


def _jax_steps(cfg, model, stacked, table, batches, mode: str):
    """The JAX ``build_fed_train_step`` (grad_avg) over ``batches``: per-step
    losses and client 0's tree after them."""
    import jax.numpy as jnp
    from fedrec_tpu.fed import get_strategy
    from fedrec_tpu.parallel import fed_mesh, shard_fed_batch
    from fedrec_tpu.train import build_fed_train_step

    mesh = fed_mesh(cfg)
    step = build_fed_train_step(model, cfg, get_strategy("grad_avg"), mesh, mode=mode)
    losses = []
    for b in batches:
        stacked, met = step(stacked, shard_fed_batch(mesh, b, cfg), jnp.asarray(table))
        losses.append(np.asarray(met["loss"]).reshape(-1))
    return np.stack(losses), _client0(stacked)


# -------------------------------------------------------------- the world
def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _shared(tmp_path_factory, name: str, compute):
    """``compute()`` once for a whole test run: under pytest-xdist the first
    worker to ask computes it and the others load its file (one world, not
    one per worker); without xdist, here."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not run:
        return compute()
    root = tmp_path_factory.getbasetemp().parent / f"torch_ring_{run}"
    root.mkdir(exist_ok=True)
    path, failed = root / f"{name}.pt", root / f"{name}.failed"
    try:
        os.close(os.open(root / f"{name}.lock", os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        deadline = time.monotonic() + 600
        while not path.exists():
            assert not failed.exists(), f"another worker failed to compute {name}"
            assert time.monotonic() < deadline, f"timed out waiting for {name}"
            time.sleep(0.2)
        return torch.load(path, weights_only=False)
    try:
        out = compute()
    except BaseException:
        failed.touch()
        raise
    torch.save(out, root / f"{name}.tmp")
    os.replace(root / f"{name}.tmp", path)
    return out


@pytest.fixture(scope="module")
def seq_world(tmp_path_factory):
    """The JAX trees the ranks start from, then one world of 4 ranks; returns
    ``(inputs, [each rank's results])``."""
    return _shared(tmp_path_factory, "seq_world",
                   lambda: _build_world(tmp_path_factory.mktemp("seq_world")))


def _build_world(work: Path):
    import jax
    from flax.core import unfreeze
    from fedrec_tpu.models.encoders import UserEncoder as JaxUserEncoder

    rng = np.random.default_rng(3)
    clicked = rng.standard_normal((B, L, 32)).astype(np.float32)
    umask = np.ones((B, L), np.float32)
    umask[:, -4:] = 0.0
    ue_params = JaxUserEncoder(**_SMALL).init(jax.random.PRNGKey(0), clicked, umask)
    jcfg = _jax_cfg("head", 1)
    _, jstate = _jax_state(jcfg, 32)
    fcfg = _jax_cfg("finetune", 1)
    _, fstate = _jax_state(fcfg, 32)
    inputs = {
        "ue": {"inputs": (clicked, umask),
               "params": jax.tree_util.tree_map(np.asarray, unfreeze(ue_params)["params"])},
        "joint": {"params": _client0(jstate), "batches": [_step_batch(11), _step_batch(12)],
                  "table": rng.standard_normal((32, 8, 48)).astype(np.float32)},
        "finetune": {"params": _client0(fstate), "batches": [_step_batch(13), _step_batch(14)],
                     "table": rng.integers(1, 500, (32, 2, 8)).astype(np.int64)},
    }
    torch.save(inputs, work / "inputs.pt")
    address = f"127.0.0.1:{_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), str(ROOT / "tests")])}
    code = ("import sys, test_torch_ring as t; "
            "t._rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(SEQ), address,
                               str(work / "inputs.pt"), str(work / f"rank{r}.pt")],
                              cwd=work, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(SEQ)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    return inputs, [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(SEQ)]


def _cat(parts, axis=1):
    return np.concatenate(parts, axis=axis)


# ----------------------------------------------------- ring and Ulysses
_JAX_CACHE: dict = {}


def _jax_attention(impl: str, masked: bool):
    """JAX's sharded function on 4 devices: the output and the gradients of
    sum(o^2) in one compile; and the dense reference's (once a mask kind)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fedrec_tpu.compat import shard_map
    from fedrec_tpu.parallel.ring import ring_attention as jring
    from fedrec_tpu.parallel.ring import ulysses_attention as julysses

    q, k, v, mask = (jnp.asarray(a) for a in _attn_inputs())
    if not masked:
        mask = jnp.ones_like(mask)
    fn = jring if impl == "ring" else julysses
    spec = P(None, "seq", None, None)
    sharded = shard_map(lambda a, b, c, m: fn(a, b, c, m if masked else None, axis_name="seq"),
                        mesh=_jax_mesh(), in_specs=(spec, spec, spec, P(None, "seq")),
                        out_specs=spec)

    def dense(a, b, c, m):
        s = jnp.einsum("bqhd,bkhd->bhqk", a, b) / jnp.sqrt(jnp.float32(D))
        s = jnp.where(m[:, None, None, :] > 0, s, -1e30)
        p = jnp.exp(s - jnp.max(s, -1, keepdims=True)) * m[:, None, None, :]
        p = p / (jnp.sum(p, -1, keepdims=True) + 1e-8)
        return jnp.einsum("bhqk,bkhd->bqhd", p, c)

    def run(f):
        (_, o), g = jax.jit(jax.value_and_grad(
            lambda a, b, c: (jnp.sum(f(a, b, c, mask) ** 2), f(a, b, c, mask)),
            argnums=(0, 1, 2), has_aux=True))(q, k, v)
        return np.asarray(o), [np.asarray(x) for x in g]

    if ("dense", masked) not in _JAX_CACHE:
        _JAX_CACHE[("dense", masked)] = run(dense)
    return {"jax": run(sharded), "dense": _JAX_CACHE[("dense", masked)]}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "maskless"])
def test_attention_matches_jax_and_dense(seq_world, impl, masked):
    _, ranks = seq_world
    got_o = _cat([r[f"attn/{impl}/{masked}"][0] for r in ranks])
    got_g = [_cat([r[f"attn/{impl}/{masked}"][1][i] for r in ranks]) for i in range(3)]
    for ref, (want_o, want_g) in _jax_attention(impl, masked).items():
        np.testing.assert_allclose(got_o, want_o, atol=1e-5, err_msg=f"output vs {ref}")
        for name, a, b in zip("qkv", got_g, want_g):
            np.testing.assert_allclose(a, b, atol=2e-4, err_msg=f"d{name} vs {ref}")


def test_ring_moves_the_mask_only_when_there_is_one(seq_world):
    """Three hops a forward and three back: (S - 1) each way, no rotation
    after the last block; the masked calls carry the mask too."""
    _, ranks = seq_world
    st = ranks[0]["stats"]
    assert st["ring_hop"]["calls"] > 0 and st["all_to_all"]["calls"] > 0
    k, v, mask = (B * (L // SEQ) * H * D * 4,) * 2 + (B * (L // SEQ) * 4,)
    # the op tests: masked fwd+bwd (k, v, mask forward; dk, dv back) and
    # maskless fwd+bwd, (S - 1) hops each
    ops = 3 * ((k + v + mask) + (k + v) + (k + v) + (k + v))
    assert st["ring_hop"]["bytes"] >= ops


def test_seq_parallel_pool_matches_jax(seq_world):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fedrec_tpu.compat import shard_map
    from fedrec_tpu.parallel.ring import seq_parallel_pool as jpool

    _, ranks = seq_world
    x, logits, mask = (jnp.asarray(a) for a in _pool_inputs())
    for key, m in (("pool/masked", mask), ("pool/maskless", None)):
        fn = shard_map(lambda a, b, c: jpool(a, b, c if m is not None else None, axis_name="seq"),
                       mesh=_jax_mesh(), in_specs=(P(None, "seq", None), P(None, "seq"),
                                                   P(None, "seq")), out_specs=P())
        want = np.asarray(fn(x, logits, mask))
        for r in ranks:  # the pooled vector, the same on every rank
            np.testing.assert_allclose(r[key], want, atol=1e-5, err_msg=key)
        assert all(np.array_equal(r[key], ranks[0][key]) for r in ranks)


# ------------------------------------------------------- the user tower
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_seq_user_encoder_forward_and_grads_match_jax(seq_world, impl):
    """The seq ``UserEncoder`` against JAX's seq encoder (forward; the ring
    one, which JAX pins to its Ulysses one at 1e-5) and the dense encoder's
    gradients (JAX's own seq-vs-dense pin): the forward at 1e-5, the
    world-summed parameter gradients at 2e-4."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from fedrec_tpu.compat import shard_map
    from fedrec_tpu.models.encoders import UserEncoder as JaxUserEncoder

    inputs, ranks = seq_world
    if "ue" not in _JAX_CACHE:
        clicked, umask = (jnp.asarray(a) for a in inputs["ue"]["inputs"])
        params = {"params": inputs["ue"]["params"]}
        sp = JaxUserEncoder(**_SMALL, seq_axis="seq", seq_impl="ring")
        _JAX_CACHE["ue"] = np.asarray(shard_map(
            lambda p, x, m: sp.apply(p, x, m), mesh=_jax_mesh(),
            in_specs=(P(), P(None, "seq", None), P(None, "seq")), out_specs=P())(
                params, clicked, umask))
    want_u = _JAX_CACHE["ue"]
    want_g = _dense_encoder_grads(inputs["ue"])
    for r in ranks:
        u, grads, names = r[f"ue/{impl}"]
        np.testing.assert_allclose(u, want_u, atol=1e-5)
        for n, gr in zip(names, grads):
            np.testing.assert_allclose(gr, want_g[n], atol=2e-4, err_msg=n)


_UE_CACHE: dict = {}


def _dense_encoder_grads(ue: dict) -> dict:
    """The dense JAX encoder's gradients of mean(u^2), by the port's
    parameter names (through the bridge), computed once."""
    if "g" not in _UE_CACHE:
        import jax
        import jax.numpy as jnp
        from fedrec_tpu.models.encoders import UserEncoder as JaxUserEncoder
        from fedrec_tpu_torch.models.encoders import UserEncoder
        from fedrec_tpu_torch.params import from_flax

        clicked, umask = (jnp.asarray(a) for a in ue["inputs"])
        dense = JaxUserEncoder(**_SMALL)
        jgrad = jax.grad(lambda p: jnp.mean(dense.apply(p, clicked, umask) ** 2))(
            {"params": ue["params"]})
        ref = UserEncoder(**_SMALL)
        from_flax(ref, jax.tree_util.tree_map(np.asarray, jgrad["params"]))
        _UE_CACHE["g"] = {n: p.detach().numpy() for n, p in ref.named_parameters()}
    return _UE_CACHE["g"]


# -------------------------------------------------------- the train steps
def _assert_tree(got: dict, want: dict, atol: float, where: str = "") -> None:
    for key, sub in want.items():
        path = f"{where}/{key}"
        if isinstance(sub, dict):
            _assert_tree(got[key], sub, atol, path)
        else:
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(sub), atol=atol,
                                       err_msg=path)


def _tree_diff(a: dict, b: dict) -> dict:
    return {k: _tree_diff(a[k], b[k]) if isinstance(b[k], dict)
            else np.asarray(a[k]) - np.asarray(b[k]) for k in b}


@pytest.fixture(scope="module")
def jax_joint(seq_world, tmp_path_factory):
    """JAX's joint step: seq_shards=4 under Adam (1 step), seq_shards=1 and
    4 under SGD at rate 1 (1 step: the parameters' change is minus the
    gradient)."""
    return _shared(tmp_path_factory, "jax_joint", lambda: _jax_joint(seq_world[0]["joint"]))


def _jax_joint(j: dict) -> dict:
    out = {}
    for key, seq, over in (("adam4", 4, {}), ("sgd1", 1, dict(optim__optimizer="sgd",
                                                            optim__user_lr=1.0,
                                                            optim__news_lr=1.0)),
                           ("sgd4", 4, dict(optim__optimizer="sgd", optim__user_lr=1.0,
                                            optim__news_lr=1.0))):
        cfg = _jax_cfg("head", seq, **over)
        model, stacked = _jax_state(cfg, 32)
        out[key] = _jax_steps(cfg, model, stacked, j["table"], j["batches"][:1], "joint")
    return out


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_joint_step_matches_jax_seq4(seq_world, jax_joint, impl):
    """The first step against the JAX step at ``fed.seq_shards=4``: the
    losses at 1e-5, the parameters after one Adam step at 2e-3 (JAX's own
    seq-vs-plain pin); then two steps against the unsharded port's (held to
    JAX in ``test_torch_train.py``); every rank holds the same bits."""
    inputs, ranks = seq_world
    j = inputs["joint"]
    losses, tree = jax_joint["adam4"]
    ref = _port_step(j["params"], _sets("head", 1), j["table"], j["batches"], None)
    key = "joint/adam" if impl == "ring" else "joint/ulysses"
    for r in ranks:
        np.testing.assert_allclose(r[key]["losses"][:1], losses, atol=1e-5)
        _assert_tree(r[key]["trees"][0], tree, 2e-3)
        np.testing.assert_allclose(r[key]["losses"], ref["losses"], atol=1e-5)
        _assert_tree({"user": r[key]["user"], "news": r[key]["news"]},
                     {"user": ref["user"], "news": ref["news"]}, 2e-3)
        for part in ("user", "news"):
            _assert_tree(r[key][part], ranks[0][key][part], 0.0)


def test_joint_step_gradients_match_jax_seq1(seq_world, jax_joint):
    """One SGD step at rate 1: the loss at 1e-5 and the gradients (the
    parameters' change) at 2e-4 against the unsharded JAX step."""
    inputs, ranks = seq_world
    losses, tree = jax_joint["sgd1"]
    start = inputs["joint"]["params"]
    want = _tree_diff({"user": start["user"], "news": start["news"]}, tree)
    for r in ranks:
        got = r["joint/sgd"]
        np.testing.assert_allclose(got["losses"], losses, atol=1e-5)
        _assert_tree(_tree_diff({"user": start["user"], "news": start["news"]},
                                {"user": got["user"], "news": got["news"]}), want, 2e-4)


def test_jax_seq4_step_counts_the_user_tower_gradient_s_times(seq_world, jax_joint):
    """A difference from the reference, pinned: the JAX step at
    ``fed.seq_shards=4`` returns the user tower's gradients at 4x the
    unsharded step's (its sums over the seq axis transpose to sums, so each
    shard's history term is counted S times), and the news tower's in
    another direction; one Adam step hides the scale, which is why its own
    pin passes. The port's gradients are the unsharded model's."""
    inputs, ranks = seq_world
    start = inputs["joint"]["params"]["user"]
    g1 = _tree_diff(start, jax_joint["sgd1"][1]["user"])
    g4 = _tree_diff(start, jax_joint["sgd4"][1]["user"])
    gp = _tree_diff(start, ranks[0]["joint/sgd"]["user"])
    kernel = ("self_attn", "w_v", "kernel")
    a, b, c = (x[kernel[0]][kernel[1]][kernel[2]] for x in (g1, g4, gp))
    assert abs(float((a * b).sum() / (a * a).sum()) - SEQ) < 1e-3
    assert abs(float((a * c).sum() / (a * a).sum()) - 1.0) < 1e-4


def test_joint_step_with_dropout_equals_the_unsharded_port(seq_world):
    """At dropout 0.2 the world draws each history's keep mask whole and
    cuts its columns: the same masks as the unsharded step, so the same
    trajectory (2e-3 after 2 Adam steps) and the same generator state."""
    inputs, ranks = seq_world
    j = inputs["joint"]
    ref = _port_step(j["params"], _sets("head", 1, "model.dropout_rate=0.2"), j["table"],
                     j["batches"], None)
    for r in ranks:
        got = r["joint/dropout"]
        np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-5)
        _assert_tree({"user": got["user"], "news": got["news"]},
                     {"user": ref["user"], "news": ref["news"]}, 2e-3)
        assert np.array_equal(got["rng"], ref["rng"])


def test_overflow_is_raised_on_a_nonzero_shard(seq_world):
    """Only rank 3's slice overflows ``data.unique_news_cap=6``: the flag is
    summed over the world, so every rank reports both clients' overflow, as
    the JAX step does."""
    _, ranks = seq_world
    for r in ranks:
        assert r["joint/overflow"]["overflow"] == [2]


def test_finetune_step_matches_jax(seq_world):
    """Finetune mode at dropout 0: the first step against JAX's
    ``seq_shards=4`` step (losses 1e-5, parameters after one Adam step
    2e-3), two Adam steps and one SGD step's gradients against the unsharded
    port's (2e-3, 2e-4; the unsharded finetune step is held to JAX in
    ``test_torch_finetune.py``)."""
    inputs, ranks = seq_world
    f = inputs["finetune"]
    cfg = _jax_cfg("finetune", 4)
    model, stacked = _jax_state(cfg, 32)
    losses, tree = _jax_steps(cfg, model, stacked, f["table"], f["batches"][:1], "finetune")
    adam = _port_step(f["params"], _sets("finetune", 1), f["table"], f["batches"], None)
    ref = _port_step(f["params"], _sets("finetune", 1, "optim.optimizer=sgd", "optim.user_lr=1",
                                        "optim.news_lr=1"), f["table"], f["batches"][:1], None)
    start = {"user": f["params"]["user"], "news": f["params"]["news"]}
    want = _tree_diff(start, {"user": ref["user"], "news": ref["news"]})
    for r in ranks:
        got = r["finetune/adam"]
        np.testing.assert_allclose(got["losses"][:1], losses, atol=1e-5)
        _assert_tree(got["trees"][0], tree, 2e-3)
        np.testing.assert_allclose(got["losses"], adam["losses"], atol=1e-5)
        _assert_tree({"user": got["user"], "news": got["news"]},
                     {"user": adam["user"], "news": adam["news"]}, 2e-3)
        got = r["finetune/sgd"]
        np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-5)
        _assert_tree(_tree_diff(start, {"user": got["user"], "news": got["news"]}), want, 2e-4)


def test_finetune_candidate_encode_is_replicated_under_dropout(seq_world):
    """At trunk dropout 0.2 the candidates, encoded apart from the local
    history shard, get the same rows and masks on every rank (JAX's
    de-replication fix), and the dropout step keeps every rank's parameters
    equal and finite."""
    _, ranks = seq_world
    for r in ranks[1:]:
        assert np.array_equal(r["finetune/cand_encode"], ranks[0]["finetune/cand_encode"])
        for part in ("user", "news"):
            _assert_tree(r["finetune/dropout"][part], ranks[0]["finetune/dropout"][part], 0.0)
    assert np.isfinite(ranks[0]["finetune/dropout"]["losses"]).all()


# ------------------------------------------------------------- refusals
def _jax_refusal(mode: str, seq: int, sharded_table=None, **over):
    from fedrec_tpu.fed import get_strategy
    from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
    from fedrec_tpu.parallel import fed_mesh
    from fedrec_tpu.train import build_fed_train_step

    cfg = _jax_cfg("head" if mode == "joint" else "finetune", seq, **over)
    if mode == "decoupled":
        cfg.model.text_encoder_mode = "table"
    kw = {"sharded_table": sharded_table} if sharded_table is not None else {}
    with pytest.raises((NotImplementedError, ValueError)) as e:
        build_fed_train_step(JaxNewsRecommender(cfg.model), cfg, get_strategy("grad_avg"),
                             fed_mesh(cfg), mode=mode, **kw)
    return e.value


_REFUSALS = {
    "decoupled": ("decoupled", {}, []),
    "dpsgd": ("joint", dict(privacy__enabled=True, privacy__sigma=1.0),
              ["privacy.enabled=1", "privacy.sigma=1"]),
    "fuse_hot_path": ("joint", dict(model__fuse_hot_path=True), ["model.fuse_hot_path=1"]),
    "shard_table": ("joint", {}, ["shard.table=1"]),
    "chaos": ("joint", dict(chaos__enabled=True), ["chaos.enabled=1"]),
}


@pytest.mark.parametrize("case", list(_REFUSALS))
def test_seq_step_refusals_match_jax_word_for_word(case):
    from fedrec_tpu_torch.config import ExperimentConfig
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.parallel.ring import SeqGroup
    from fedrec_tpu_torch.train import build_fed_train_step

    mode, over, sets = _REFUSALS[case]
    want = _jax_refusal(mode, 4, sharded_table=object() if case == "shard_table" else None,
                        **over)
    cfg = ExperimentConfig().apply_overrides(_sets("head", 4, *sets))
    with pytest.raises(type(want)) as got:
        build_fed_train_step(NewsRecommender(cfg.model), cfg, get_strategy("grad_avg"),
                             mode=mode, device="cpu", seq_group=SeqGroup(0, 1))
    assert str(got.value) == str(want)


def test_layout_and_module_refusals_match_jax():
    """``fed_mesh``'s refusals (the history must divide, fsdp and seq claim
    the same axis), Ulysses' head count, the recommender's fused and GRU
    towers under seq, each with JAX's words; and a seq step without its
    world."""
    import jax
    import jax.numpy as jnp
    from fedrec_tpu.models import NewsRecommender as JaxNewsRecommender
    from fedrec_tpu.parallel import fed_mesh
    from fedrec_tpu.parallel.ring import ulysses_attention as julysses
    from fedrec_tpu_torch.config import ExperimentConfig, ModelConfig
    from fedrec_tpu_torch.fed import get_strategy
    from fedrec_tpu_torch.models import NewsRecommender
    from fedrec_tpu_torch.parallel.mesh import check_seq_layout
    from fedrec_tpu_torch.parallel.ring import SeqGroup, ulysses_attention
    from fedrec_tpu_torch.train import build_fed_train_step

    for jover, sets in ((dict(data__max_his_len=18), ["data.max_his_len=18"]),
                        (dict(shard__fsdp=2), ["shard.fsdp=2"])):
        with pytest.raises(ValueError) as want:
            fed_mesh(_jax_cfg("head", 4, **jover))
        with pytest.raises(ValueError) as got:
            check_seq_layout(ExperimentConfig().apply_overrides(_sets("head", 4, *sets)))
        assert str(got.value) == str(want.value)

    class _Three(SeqGroup):  # a world of 3 whose collectives are never reached
        def __init__(self):
            super().__init__(0, 3, pg=object())

    x = torch.zeros((1, 2, H, D))
    with pytest.raises(ValueError) as got:
        ulysses_attention(x, x, x, None, _Three())
    with pytest.raises(ValueError) as want:
        from jax.sharding import Mesh, PartitionSpec as P
        from fedrec_tpu.compat import shard_map

        mesh = Mesh(np.array(jax.devices()[:3]), ("seq",))
        spec = P(None, "seq", None, None)
        xs = jnp.zeros((1, 6, H, D))
        shard_map(lambda a, b, c: julysses(a, b, c, None, axis_name="seq"), mesh=mesh,
                  in_specs=(spec, spec, spec), out_specs=spec)(xs, xs, xs)
    assert str(got.value) == str(want.value)

    for over in (dict(fuse_hot_path=True), dict(user_tower="gru")):
        jcfg = _jax_cfg("head", 1)
        for key, val in over.items():
            setattr(jcfg.model, key, val)
        with pytest.raises(ValueError) as want:
            JaxNewsRecommender(jcfg.model, seq_axis="seq").init(
                jax.random.PRNGKey(0), jnp.zeros((1, 5, 32)), jnp.zeros((1, L, 32)))
        with pytest.raises(ValueError) as got:
            NewsRecommender(ModelConfig(**_SMALL, bert_hidden=48, **over)).seq_parallel(
                SeqGroup(0, 1))
        assert str(got.value) == str(want.value)

    cfg = ExperimentConfig().apply_overrides(_sets("head", 4))
    with pytest.raises(ValueError, match="fed.seq_shards=4 but the step has none"):
        build_fed_train_step(NewsRecommender(cfg.model), cfg, get_strategy("grad_avg"),
                             device="cpu")
