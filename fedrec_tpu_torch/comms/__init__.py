"""Update-compression codecs (``fed.dcn_compress``) for the round-end sync
and the coordinator's wire. See :mod:`fedrec_tpu_torch.comms.codecs`."""

from fedrec_tpu_torch.comms.codecs import (
    CODEC_CAPS,
    CODECS,
    DEFAULT_SKETCH_SEED,
    DEFAULT_SKETCH_WIDTH,
    EF_CODECS,
    SKETCH_PAYLOAD_KEY,
    CodecCaps,
    CodecState,
    EncodedTree,
    codec_caps,
    codec_state_bytes,
    codec_uses_feedback,
    decode_gathered,
    decode_leaf,
    decode_tree,
    encode_leaf,
    encode_tree,
    leaf_names,
    load_codec_state,
    payload_nbytes,
    sketch_dims,
    sum_payloads,
    topk_count,
    torch_encode_decode,
    tree_dense_nbytes,
    tree_rmse,
    validate_codec,
)

__all__ = [
    "CODEC_CAPS", "CODECS", "DEFAULT_SKETCH_SEED", "DEFAULT_SKETCH_WIDTH", "EF_CODECS",
    "SKETCH_PAYLOAD_KEY", "CodecCaps", "CodecState", "EncodedTree",
    "codec_caps", "codec_state_bytes", "codec_uses_feedback",
    "decode_gathered", "decode_leaf", "decode_tree", "encode_leaf", "encode_tree", "leaf_names",
    "load_codec_state", "payload_nbytes", "sketch_dims", "sum_payloads", "topk_count",
    "torch_encode_decode", "tree_dense_nbytes", "tree_rmse", "validate_codec",
]
