"""Update-compression codecs for the client-to-server sync, the port of
``fedrec_tpu/comms/codecs.py`` (``fed.dcn_compress``).

One registry serves both places an update crosses a wire:

* the **round-end sync** of the single-process trainer
  (``train.step.build_param_sync``): each client's round delta goes
  through :func:`torch_encode_decode` on the device, the arithmetic twin of
  the wire codec; ``sign1bit`` and ``topk`` carry a per-client
  error-feedback residual (``ClientState.ef_residual``);
* the **coordinator's gather** (``parallel.multihost.aggregate_from_hosts``):
  the numpy codecs below encode each process's contribution into the
  buffers that travel, every contribution is decoded before any reduction
  (decode-before-reduce), and the byte counts come from those buffers.

Codecs: ``none`` (dense f32), ``int8`` (symmetric per-tensor, ``scale =
max|x| / 127``), ``sign1bit`` (one bit an element and ``mean|x|``),
``topk`` (the ``ceil(ratio * n)`` largest |x|, ties to the lowest flat
index), ``countsketch`` (``y[h(i)] += s(i) x[i]`` into ``ceil(width * n)``
buckets, decode ``s(i) y[h(i)]``) and ``randproj`` (256-wide chunks
through a shared ``+-1/sqrt(d)`` matrix, decode ``y R^T``). The two
sketches are linear: a summed payload decodes to the sum of the decodes, so
they reduce in sketch space (mean only); the others decode per
contribution, so robust reductions compose with them.

Leaf layout and order. A contribution is the ``(user, news)`` pair of Flax
trees (``params.to_flax``: Dense kernels ``(in, out)``), flattened as JAX
flattens it (``utils.pytree``). Top-k's tie-break, count-sketch's hash
(keyed on the leaf index and the flat index) and randproj's chunks all
depend on that order, so the port's payloads are byte-identical to the JAX
package's for the same tree. The numpy arithmetic is the JAX package's line
for line; the torch twin follows its jnp twin (f32 scales, round half to
even, a stable sort for the top-k tie-break), and takes count-sketch's
bucket sums in f64 as the wire's ``bincount`` does, without atomics, so
that it repeats to the bit on the card.

DP ordering: clipping and noise happen inside the train step, before any
encode sees the update.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import numpy as np

if TYPE_CHECKING:
    import torch

from fedrec_tpu_torch.utils.pytree import (
    num_leaves,
    tree_flatten,
    tree_leaves,
    tree_paths,
    tree_unflatten,
)

CODECS = ("none", "int8", "sign1bit", "topk", "countsketch", "randproj")

DEFAULT_SKETCH_WIDTH = 0.1
DEFAULT_SKETCH_SEED = 0
# randproj chunk: flat tensors project 256 coordinates at a time
_RP_CHUNK = 256


@dataclass(frozen=True)
class CodecCaps:
    """What every dispatch site consults: ``decodes_per_contribution``
    (decode before reduce, so robust methods compose), ``is_linear``
    (sum then decode) and ``supports_error_feedback`` (a biased codec worth
    a residual)."""

    decodes_per_contribution: bool
    is_linear: bool
    supports_error_feedback: bool


CODEC_CAPS: dict[str, CodecCaps] = {
    "none": CodecCaps(True, True, False),
    "int8": CodecCaps(True, False, False),
    "sign1bit": CodecCaps(True, False, True),
    "topk": CodecCaps(True, False, True),
    "countsketch": CodecCaps(False, True, False),
    "randproj": CodecCaps(False, True, False),
}

EF_CODECS = tuple(c for c in CODECS if CODEC_CAPS[c].supports_error_feedback)

# the payload key of each linear sketch's one array: what the async buffer
# holds for a sketch-coded contribution, summed in sketch space at commit
SKETCH_PAYLOAD_KEY = {"countsketch": "sketch", "randproj": "proj"}


def validate_codec(name: str) -> str:
    """Fail fast on a bad codec name: raised inside a collective, a typo
    would read as a peer failure and degrade every host."""
    if name not in CODECS:
        raise ValueError(f"unknown fed.dcn_compress codec {name!r}; expected one of {CODECS}")
    return name


def codec_caps(codec: str) -> CodecCaps:
    validate_codec(codec)
    return CODEC_CAPS[codec]


def codec_uses_feedback(codec: str, error_feedback: bool = True) -> bool:
    """True when ``codec`` keeps per-client error-feedback residuals.
    ``auto`` (the per-leaf map pinned from warm-up telemetry) allocates them:
    its pinned map may put a biased codec on some leaves."""
    if codec == "auto":
        return error_feedback
    return error_feedback and codec in EF_CODECS


def sketch_dims(size: int, width: float) -> int:
    """``ceil(width * size)`` buckets, at least 1, at most ``size``."""
    if not 0.0 < width <= 1.0:
        raise ValueError(f"fed.dcn_sketch_width must be in (0, 1], got {width}")
    return max(1, min(int(size), int(np.ceil(width * float(size)))))


def _sketch_hashes(seed: int, leaf_id: int, n: int, m: int) -> tuple[np.ndarray, np.ndarray]:
    """Count-sketch's ``h : [n] -> [m]`` and ``s : [n] -> +-1`` for one
    leaf, from ``(seed, leaf_id, n, m)`` only, so every endpoint derives the
    same maps."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) & 0x7FFFFFFF, int(leaf_id), n, m])
    )
    h = rng.integers(0, m, size=n, dtype=np.int64)
    s = (rng.integers(0, 2, size=n).astype(np.float32) * 2.0 - 1.0)
    return h, s


def _randproj_matrix(seed: int, leaf_id: int, d: int) -> np.ndarray:
    """The shared per-leaf (256, d) projection, iid ``+-1/sqrt(d)``."""
    rng = np.random.default_rng(
        np.random.SeedSequence([(int(seed) + 1) & 0x7FFFFFFF, int(leaf_id), _RP_CHUNK, d])
    )
    signs = rng.integers(0, 2, size=(_RP_CHUNK, d)).astype(np.float32)
    return (signs * 2.0 - 1.0) / np.float32(np.sqrt(d))


def _sketch_plan(seed: int, leaf_id: int, n: int, m: int) -> tuple[np.ndarray, ...]:
    """The hash and sign, the order that sorts the coordinates by bucket
    (stable) and each bucket's bounds in that order: the twin's
    atomic-free bucket sums."""
    h, s = _sketch_hashes(seed, leaf_id, n, m)
    order = np.argsort(h, kind="stable")
    bounds = np.concatenate([[0], np.cumsum(np.bincount(h, minlength=m))])
    return h, s, order, bounds


def topk_count(size: int, ratio: float) -> int:
    """Coordinates kept per tensor under ``topk``: ``ceil(ratio * size)``."""
    if not 0.0 < ratio <= 1.0:
        raise ValueError(f"fed.dcn_topk_ratio must be in (0, 1], got {ratio}")
    return max(1, min(int(size), int(np.ceil(ratio * float(size)))))


# ------------------------------------------------------------ numpy (wire)
def encode_leaf(
    x: np.ndarray,
    codec: str,
    topk_ratio: float = 0.01,
    *,
    sketch_width: float = DEFAULT_SKETCH_WIDTH,
    sketch_seed: int = DEFAULT_SKETCH_SEED,
    leaf_id: int = 0,
) -> dict:
    """One tensor to its wire payload, a flat dict of numpy arrays."""
    x = np.asarray(x, np.float32)
    if codec == "none":
        return {"dense": x}
    if codec == "countsketch":
        flat = x.reshape(-1)
        n = flat.size
        m = sketch_dims(max(n, 1), sketch_width)
        h, s = _sketch_hashes(sketch_seed, leaf_id, n, m)
        y = np.bincount(h, weights=(s * flat).astype(np.float64), minlength=m)
        return {"sketch": y.astype(np.float32)}
    if codec == "randproj":
        flat = x.reshape(-1)
        n = flat.size
        d = sketch_dims(_RP_CHUNK, sketch_width)
        nchunks = max(1, -(-n // _RP_CHUNK))
        xp = np.pad(flat, (0, nchunks * _RP_CHUNK - n)).reshape(nchunks, _RP_CHUNK)
        y = xp @ _randproj_matrix(sketch_seed, leaf_id, d)
        return {"proj": y.astype(np.float32)}
    if codec == "int8":
        amax = float(np.max(np.abs(x))) if x.size else 0.0
        scale = np.float32(amax / 127.0)
        if scale == 0.0:
            q = np.zeros(x.shape, np.int8)
        else:
            q = np.clip(np.rint(x / scale), -127, 127).astype(np.int8)
        return {"q": q, "scale": np.float32(scale)}
    if codec == "sign1bit":
        scale = np.float32(np.mean(np.abs(x))) if x.size else np.float32(0.0)
        bits = np.packbits((x >= 0).reshape(-1))
        return {"bits": bits, "scale": scale}
    if codec == "topk":
        flat = x.reshape(-1)
        k = topk_count(flat.size, topk_ratio)
        # descending |x|, ties to the lowest flat index (a stable sort)
        idx = np.argsort(-np.abs(flat), kind="stable")[:k].astype(np.int32)
        return {"idx": idx, "val": flat[idx].astype(np.float32)}
    raise ValueError(f"unknown codec {codec!r}")


def decode_leaf(
    payload: dict,
    codec: str,
    shape: tuple,
    *,
    sketch_seed: int = DEFAULT_SKETCH_SEED,
    leaf_id: int = 0,
) -> np.ndarray:
    """Wire payload to a dense f32 tensor of ``shape``. Linear for the
    sketches, so it decodes a summed payload too."""
    if codec == "none":
        return np.asarray(payload["dense"], np.float32).reshape(shape)
    if codec == "countsketch":
        y = np.asarray(payload["sketch"], np.float32)
        n = int(np.prod(shape)) if shape else 1
        h, s = _sketch_hashes(sketch_seed, leaf_id, n, y.shape[0])
        return (s * y[h]).astype(np.float32).reshape(shape)
    if codec == "randproj":
        y = np.asarray(payload["proj"], np.float32)
        n = int(np.prod(shape)) if shape else 1
        r = _randproj_matrix(sketch_seed, leaf_id, y.shape[-1])
        return (y @ r.T).reshape(-1)[:n].astype(np.float32).reshape(shape)
    if codec == "int8":
        return payload["q"].astype(np.float32) * np.float32(payload["scale"])
    if codec == "sign1bit":
        n = int(np.prod(shape)) if shape else 1
        scale = np.float32(payload["scale"])
        b = np.unpackbits(np.asarray(payload["bits"], np.uint8))[:n]
        return np.where(b > 0, scale, -scale).astype(np.float32).reshape(shape)
    if codec == "topk":
        n = int(np.prod(shape)) if shape else 1
        out = np.zeros((n,), np.float32)
        out[np.asarray(payload["idx"], np.int64)] = np.asarray(payload["val"], np.float32)
        return out.reshape(shape)
    raise ValueError(f"unknown codec {codec!r}")


def payload_nbytes(payload: dict) -> int:
    """Measured wire bytes of one leaf's payload (its buffers' sizes)."""
    return int(sum(np.asarray(v).nbytes for v in payload.values()))


@dataclass
class EncodedTree:
    """One contribution, encoded: the per-leaf payloads (what travels) and
    the host metadata that decodes any process's copy. ``leaf_codecs``, when
    set, is the per-leaf map that ``fed.dcn_compress='auto'`` pins: one codec
    a flattened leaf, over the tree-wide ``codec`` label."""

    codec: str
    payloads: list
    shapes: list
    treedef: Any
    leaf_codecs: list | None = None
    sketch_width: float = DEFAULT_SKETCH_WIDTH
    sketch_seed: int = DEFAULT_SKETCH_SEED

    def leaf_codec(self, i: int) -> str:
        return self.codec if self.leaf_codecs is None else self.leaf_codecs[i]

    def nbytes(self) -> int:
        return int(sum(payload_nbytes(p) for p in self.payloads))


def encode_tree(
    tree: Any,
    codec: str,
    topk_ratio: float = 0.01,
    *,
    sketch_width: float = DEFAULT_SKETCH_WIDTH,
    sketch_seed: int = DEFAULT_SKETCH_SEED,
    leaf_codecs: list | None = None,
) -> EncodedTree:
    """``tree``'s leaves, flattened, each through ``encode_leaf`` with its
    leaf index; ``leaf_codecs`` (one codec a leaf) overrides ``codec``."""
    flat, treedef = tree_flatten(tree)
    flat = [np.asarray(x, np.float32) for x in flat]
    if leaf_codecs is None:
        validate_codec(codec)
        per_leaf = [codec] * len(flat)
    else:
        if len(leaf_codecs) != len(flat):
            raise ValueError(
                f"per-leaf codec map has {len(leaf_codecs)} entries but the tree has "
                f"{len(flat)} leaves — stale fed.dcn_compress=auto map for this model config?")
        per_leaf = [validate_codec(c) for c in leaf_codecs]
    return EncodedTree(
        codec=codec,
        payloads=[encode_leaf(x, c, topk_ratio, sketch_width=sketch_width,
                              sketch_seed=sketch_seed, leaf_id=i)
                  for i, (x, c) in enumerate(zip(flat, per_leaf))],
        shapes=[x.shape for x in flat],
        treedef=treedef,
        leaf_codecs=None if leaf_codecs is None else list(leaf_codecs),
        sketch_width=sketch_width,
        sketch_seed=sketch_seed,
    )


def decode_tree(enc: EncodedTree) -> Any:
    leaves = [decode_leaf(p, enc.leaf_codec(i), s, sketch_seed=enc.sketch_seed, leaf_id=i)
              for i, (p, s) in enumerate(zip(enc.payloads, enc.shapes))]
    return tree_unflatten(enc.treedef, leaves)


def decode_gathered(gathered_payloads: list, enc: EncodedTree) -> Any:
    """Decode a gathered copy of ``enc``'s payloads (each array with a
    leading (P,) process dim) into a tree of dense (P, *shape) f32 stacks:
    the decode-before-reduce step. Only for codecs that decode per
    contribution (each leaf by its own codec under a per-leaf map); linear
    sketches go through :func:`sum_payloads` and one :func:`decode_leaf`."""
    leaves = []
    for i, (payload, shape) in enumerate(zip(gathered_payloads, enc.shapes)):
        num_p = int(np.asarray(next(iter(payload.values()))).shape[0])
        leaves.append(np.stack([
            decode_leaf({k: np.asarray(v)[p] for k, v in payload.items()},
                        enc.leaf_codec(i), shape, sketch_seed=enc.sketch_seed, leaf_id=i)
            for p in range(num_p)
        ]))
    return tree_unflatten(enc.treedef, leaves)


def sum_payloads(payload: dict, coeffs: np.ndarray) -> dict:
    """Coefficient-weighted sum of one leaf's gathered payload over its
    leading (P,) dim: the sum-then-decode reduce of a linear sketch."""
    c = np.asarray(coeffs, np.float32)
    return {k: np.tensordot(c, np.asarray(v, np.float32), axes=(0, 0))
            for k, v in payload.items()}


def tree_dense_nbytes(tree: Any) -> int:
    """Bytes the contribution costs uncompressed (dense f32)."""
    return int(sum(4 * np.asarray(x).size for x in tree_leaves(tree)))


def leaf_names(tree: Any) -> list:
    """Each flattened leaf's key path joined with '/' (``0/pool/att_fc1/bias``
    for the user tower's first leaf of a ``(user, news)`` pair), as the JAX
    package names them."""
    return ["/".join(str(p) for p in path) if path else "param" for path in tree_paths(tree)]


def tree_rmse(a: Any, b: Any) -> float:
    """Root-mean-square difference of two trees, over every coordinate."""
    sq, n = 0.0, 0
    for xa, xb in zip(tree_leaves(a), tree_leaves(b)):
        d = np.asarray(xa, np.float64) - np.asarray(xb, np.float64)
        sq += float(np.sum(d * d))
        n += int(d.size)
    return float(np.sqrt(sq / max(n, 1)))


# -------------------------------------------------- torch (on-device twin)
_DEVICE_CONSTS: dict = {}


def _device_const(key: tuple, make, device: torch.device) -> Any:
    """A seeded hash or projection, built on the host once and kept on
    ``device`` (the maps depend only on the seed, the leaf and its size)."""
    import torch

    full = key + (str(device),)
    if full not in _DEVICE_CONSTS:
        _DEVICE_CONSTS[full] = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                                     for a in make())
    return _DEVICE_CONSTS[full]


def torch_encode_decode(
    x: torch.Tensor,
    codec: str,
    topk_ratio: float = 0.01,
    *,
    sketch_width: float = DEFAULT_SKETCH_WIDTH,
    sketch_seed: int = DEFAULT_SKETCH_SEED,
    leaf_id: int = 0,
) -> torch.Tensor:
    """``decode_leaf(encode_leaf(x))`` on ``x``'s device, the arithmetic of
    the JAX package's ``jax_encode_decode``: an f32 scale ``max|x| / 127``
    and round half to even for ``int8``, ``mean|x|`` for ``sign1bit``, a
    stable descending sort of |x| for ``topk`` (ties to the lowest flat
    index), the wire codec's seeded hash and projection for the sketches.
    ``x`` must be in the Flax layout the wire codec sees."""
    import torch

    xf = x.to(torch.float32)
    if codec == "none":
        return xf
    dev = xf.device
    if codec == "countsketch":
        flat = xf.reshape(-1)
        n = flat.numel()
        m = sketch_dims(max(n, 1), sketch_width)
        h, s, order, bounds = _device_const(("cs", sketch_seed, leaf_id, n, m),
                                            lambda: _sketch_plan(sketch_seed, leaf_id, n, m), dev)
        # each bucket's sum in f64, as the wire codec's bincount takes it, and
        # without atomics (an index_add_ on the card would not repeat to the
        # bit): the terms sorted by bucket, one prefix sum, its differences
        cs = torch.cumsum((s * flat).double()[order], 0)
        cs = torch.cat([cs.new_zeros(1), cs])
        y = (cs[bounds[1:]] - cs[bounds[:-1]]).float()
        return (s * y[h]).reshape(xf.shape)
    if codec == "randproj":
        flat = xf.reshape(-1)
        n = flat.numel()
        d = sketch_dims(_RP_CHUNK, sketch_width)
        (r,) = _device_const(("rp", sketch_seed, leaf_id, d),
                             lambda: (_randproj_matrix(sketch_seed, leaf_id, d),), dev)
        nchunks = max(1, -(-n // _RP_CHUNK))
        xp = torch.nn.functional.pad(flat, (0, nchunks * _RP_CHUNK - n))
        xhat = (xp.reshape(nchunks, _RP_CHUNK) @ r) @ r.T
        return xhat.reshape(-1)[:n].reshape(xf.shape)
    if codec == "int8":
        scale = xf.abs().max() / 127.0
        q = torch.clamp(torch.round(xf / torch.where(scale > 0, scale, torch.ones_like(scale))),
                        -127, 127).to(torch.int8)
        return q.to(torch.float32) * scale
    if codec == "sign1bit":
        scale = xf.abs().mean()
        return torch.where(xf >= 0, scale, -scale)
    if codec == "topk":
        flat = xf.reshape(-1)
        k = topk_count(flat.numel(), topk_ratio)
        idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
        out = torch.zeros_like(flat)
        out[idx] = flat[idx]
        return out.reshape(xf.shape)
    raise ValueError(f"unknown codec {codec!r}")


# -------------------------------------------------- host residual sidecar
@dataclass
class CodecState:
    """The coordinator process's error-feedback residual (the wire
    endpoint's; the trainer's per-client residuals live in
    ``ClientState.ef_residual``)."""

    residual: Any = None


def codec_state_bytes(state: CodecState, round_idx: int) -> bytes:
    """The residual as ``.npz`` bytes, the JAX package's layout (``round``,
    ``count``, ``leaf_<i>`` in leaf order)."""
    buf = io.BytesIO()
    leaves = [] if state.residual is None else [np.asarray(x) for x in tree_leaves(state.residual)]
    np.savez(buf, round=np.int64(round_idx), count=np.int64(len(leaves)),
             **{f"leaf_{i}": x for i, x in enumerate(leaves)})
    return buf.getvalue()


def load_codec_state(blob: bytes, template_tree: Any) -> tuple[CodecState, int]:
    """Restore a residual written by :func:`codec_state_bytes` (the port's
    or the JAX package's) into ``template_tree``'s structure; a zero-leaf
    blob restores ``residual=None``."""
    with np.load(io.BytesIO(blob), allow_pickle=False) as z:
        round_idx = int(z["round"])
        count = int(z["count"])
        if count == 0:
            return CodecState(residual=None), round_idx
        leaves = [z[f"leaf_{i}"] for i in range(count)]
    treedef = tree_flatten(template_tree)[1]
    if num_leaves(treedef) != len(leaves):
        raise ValueError(
            f"residual sidecar holds {len(leaves)} leaves but the contribution tree has "
            f"{num_leaves(treedef)}: config changed since the sidecar was written?"
        )
    return CodecState(residual=tree_unflatten(treedef, leaves)), round_idx
