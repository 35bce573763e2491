from fedrec_tpu_torch.train.state import (
    ClientState,
    init_client_state,
    make_optimizers,
    replicate_state,
    stack_states,
)
from fedrec_tpu_torch.train.step import (
    build_fed_train_step,
    build_param_sync,
    encode_all_news,
    resolve_unique_cap,
    unique_overflow,
)

__all__ = [
    "ClientState",
    "build_fed_train_step",
    "build_param_sync",
    "encode_all_news",
    "init_client_state",
    "make_optimizers",
    "replicate_state",
    "resolve_unique_cap",
    "stack_states",
    "unique_overflow",
]
