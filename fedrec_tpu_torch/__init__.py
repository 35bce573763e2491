"""PyTorch/CUDA port of ``fedrec_tpu``, grown slice by slice beside it.

The JAX package stays the reference; every module here keeps the name and
place of its counterpart there, so a reader finds one from the other. This
package imports ``torch`` and never ``jax``, ``flax`` or ``fedrec_tpu``:
what it needs from the JAX package's host-only modules it keeps as its own
copy (``config``, ``obs``, ``privacy.accountant``, ``parallel.rpc``).

Slice 1 is serving: one user's click history in, the top-k news ids out
(``train.step.encode_all_news`` -> ``serving.store`` -> ``serve``'s exact
scorer -> ``serving.server``). Its two TPU kernels are hand-written CUDA
kernels for Hopper (``ops/csrc``): the additive pool of the corpus encode
and the fused user tower of every served batch. Serving also restores
training snapshots (``serving.store.publish_from_checkpoint``), hot-swaps
them under load (``{"cmd": "refresh"}``), retrieves from large catalogs in
two stages (``serving.retrieval``), and has a resilient client
(``serving.client``) and a one-shot CLI (``cli.recommend``).

Entry points run on ``cuda`` unless the caller asks for ``device="cpu"``
(``fedrec_tpu_torch.device``).
"""

__version__ = "0.1.0"
