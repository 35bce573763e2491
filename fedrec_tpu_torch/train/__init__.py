from fedrec_tpu_torch.train.checkpoint import (
    SnapshotIntegrityError,
    SnapshotManager,
    atomic_write_bytes,
    verify_state_tree,
)
from fedrec_tpu_torch.train.state import (
    ClientState,
    init_client_state,
    make_optimizers,
    replicate_state,
    stack_states,
)
from fedrec_tpu_torch.train.step import (
    build_eval_step,
    build_fed_train_step,
    build_full_eval_step,
    build_news_update_step,
    build_param_sync,
    encode_all_news,
    encode_corpus_tokens,
    resolve_unique_cap,
    scatter_add_rows,
    unique_overflow,
)
from fedrec_tpu_torch.train.trainer import RoundResult, Trainer

__all__ = [
    "ClientState",
    "RoundResult",
    "SnapshotIntegrityError",
    "SnapshotManager",
    "Trainer",
    "atomic_write_bytes",
    "build_eval_step",
    "build_fed_train_step",
    "build_full_eval_step",
    "build_news_update_step",
    "build_param_sync",
    "encode_all_news",
    "encode_corpus_tokens",
    "init_client_state",
    "make_optimizers",
    "replicate_state",
    "resolve_unique_cap",
    "scatter_add_rows",
    "stack_states",
    "unique_overflow",
    "verify_state_tree",
]
