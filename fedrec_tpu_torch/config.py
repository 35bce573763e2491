"""Configuration for the port: the fields of ``fedrec_tpu.config`` that the
ported slices read, with the same names and defaults.

A copy, not an import: the port never imports the JAX package. ``--set
section.key=value`` overrides work as they do there
(``ExperimentConfig.apply_overrides``), nested paths included
(``obs.health.sentry=0``).

Some fields exist only so that a lever the port does not run yet can be
named and refused at build time (``train.step.build_fed_train_step`` and
``train.trainer.Trainer``): ``shard.table`` and ``shard.fsdp`` (ROADMAP.md's
Queue A item 9). ``obs.health``'s flight-recorder fields are inert
without ``obs.dir``, as in the JAX package; ``obs.perf.compile_cost`` is
accepted and inert (the port has no XLA compiles to price).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class DataConfig:
    """Dataset and batching knobs."""

    data_dir: str = "UserData"         # the reference's artifacts (cli/run.py)
    dataset: str = "mind"              # "mind" | "adressa" | "synthetic"
    npratio: int = 4                   # negatives per impression
    max_his_len: int = 50              # click-history cap (pad id 0 = <unk>)
    max_title_len: int = 50            # tokens per news title
    batch_size: int = 64
    shuffle: bool = True
    seed: int = 0                      # the batcher's and the population's seed
    drop_remainder: bool = True
    # this process's disjoint slice of the training set: shard shard_index of
    # num_shards, dealt from a data.seed-seeded permutation
    # (data.batcher.process_shard_indices); 0 or 1 = the whole set
    num_shards: int = 0
    shard_index: int = 0
    # static bound on the unique news encoded per joint-mode step; 0 = the
    # exact worst case B*(C+H). Exact while a batch's distinct ids stay
    # <= cap; the step reports `unique_overflow` otherwise
    unique_news_cap: int = 0
    # per-B cap policy "64:2560,256:4096"; empty = the global cap
    unique_news_cap_buckets: str = ""
    # joint mode: gather + encode the unique news in tiles of this many ids,
    # each tile recomputed in backward (one tile's activations live at a
    # time); 0 = untiled. Row-wise, so exact
    gather_chunk: int = 0
    # batches built ahead on a producer thread (data.prefetch.Prefetcher);
    # the queue depth, 0 = off. Same batches in the same order either way
    prefetch_batches: int = 0
    # host-side batch assembly in the native C++ engine
    # (data.native_batcher, built with g++ at first use; threaded). The
    # same batches as the JAX package's engine; raises when it cannot build
    native_loader: bool = False


@dataclass
class ModelConfig:
    """Two-tower model hyperparameters (defaults as ``fedrec_tpu``'s)."""

    news_dim: int = 400                # news/user embedding dim
    num_heads: int = 20                # user-encoder MHA heads
    head_dim: int = 20                 # d_k = d_v
    query_dim: int = 200               # additive-attention query hidden
    dropout_rate: float = 0.2
    user_tower: str = "mha"            # "mha" | "gru" (LSTUR-style recurrent tower)
    # "additive" (the reference's head) | "cnn" (NAML-style Conv1D + ReLU +
    # additive pooling)
    text_head_arch: str = "additive"
    cnn_kernel: int = 3                # CNN head context window
    bert_hidden: int = 768             # frozen-trunk hidden size
    # "table" (decoupled: the user tower trains on a news-vector table, the
    # text head steps once an epoch) | "head" (joint, frozen-trunk token
    # states) | "finetune" (the DistilBERT trunk trained in the loop over
    # the (N, 2, L) token table, models.bert.TextEncoder)
    text_encoder_mode: str = "table"
    # the trunk of "finetune" mode (defaults = distilbert-base-uncased; its
    # width is bert_hidden)
    trunk_layers: int = 6
    trunk_heads: int = 12
    trunk_ffn: int = 3072
    trunk_vocab: int = 30522
    trunk_dropout: float = 0.1         # hidden and attention dropout (HF's default)
    trunk_remat: bool = True           # recompute each block in backward (memory for FLOPs)
    # the reference's CrossEntropyLoss over sigmoid(scores)
    sigmoid_before_ce: bool = True
    # max-subtracted exp-normalization; False is the reference's raw exp
    stable_softmax: bool = True
    dtype: str = "float32"             # "float32" | "bfloat16"
    # route the text head's additive pool through kernel A (additive_pool)
    use_pallas: bool = False
    # route the user tower through kernels B/E (fused_history_score) and the
    # joint step's gather + text head through kernels C/D (fused_gather_encode)
    fuse_hot_path: bool = False
    # the unfused user tower's self-attention:
    #   "auto"    - flash attention (kernels F1-F3) under use_pallas with
    #               stable_softmax; else dense up to attn_chunk_threshold
    #               history items, then the blockwise chunked loop (O(L)
    #               memory); see MultiHeadAttention.resolve_impl
    #   "dense" | "chunked" | "pallas" - force one route
    attn_impl: str = "auto"
    attn_chunk_threshold: int = 1024


@dataclass
class OptimConfig:
    """Two optimizer chains, one per tower (``train.state.make_optimizers``)."""

    user_lr: float = 5e-5
    news_lr: float = 5e-5
    optimizer: str = "adam"            # "adam" | "sgd"
    grad_clip_norm: float = 0.0        # 0 = off
    lr_schedule: str = "constant"      # "constant" | "cosine"
    decay_steps: int = 0               # cosine horizon; 0 = constant
    lr_min_frac: float = 0.1           # cosine floor, as a fraction of lr


@dataclass
class RobustConfig:
    """Byzantine-robust aggregation and quarantine-and-rollback recovery.

    ``method`` picks the round-end aggregator (``fed.robust``): "mean"
    (participation-weighted FedAvg, the default, bitwise the plain mean),
    "clip" (each client's deviation from the coordinate-wise cohort median
    clipped to ``clip_norm`` in one global L2 over both towers, then
    weighted-mean'd; non-finite contributions clip to zero),
    "trimmed_mean" (coordinate-wise, the ``trim_k`` highest and lowest
    finite participant values dropped) or "median" (coordinate-wise).

    ``recover`` turns the health sentry's detection into reaction: on a
    non-finite update or an outlier client (round-mean update norm >
    ``obs.health.outlier_k`` x the cohort median) the trainer quarantines
    the client (weight 0 for ``quarantine_rounds`` rounds), rolls the
    cohort back to the round-entry state and replays the round — up to
    ``max_retries`` distinct quarantines a round, then the abort. A
    quarantined client rejoins healed: params reset to the global,
    optimizer state zeroed.
    """

    method: str = "mean"               # "mean" | "clip" | "trimmed_mean" | "median"
    trim_k: int = 1                    # coords trimmed from EACH end (trimmed_mean)
    clip_norm: float = 10.0            # global-L2 clip for method="clip"
    recover: bool = False              # quarantine + rollback instead of abort
    quarantine_rounds: int = 3         # rounds a flagged client sits out
    max_retries: int = 2               # rollback/replay attempts per round


@dataclass
class PopulationConfig:
    """The cross-device cohort engine (``fed.population``): ``num_clients``
    logical clients sampled onto the ``fed.num_clients`` device slots each
    round. A round draws ``ceil(slots * over_select)`` candidates
    (``fed.sampling.CohortSampler``), packs the survivors of the chaos
    plan's population dropout into the slots, and gives weight 0 to those
    whose simulated report latency passes ``round_deadline_ms``. Below
    ``min_reports`` reporters the round is discarded and replayed with a
    fresh draw, at most ``quorum_retries`` times.

    ``num_clients == fed.num_clients`` is the degenerate (cross-silo) world,
    bitwise the run without a population. Above it, each logical client owns
    a seeded, equal shard of the training set, and its optimizer sidecar
    persists across selections (``client_state="persist"``) or restarts
    from the template (``"reset"``). Sidecars above ``resident_cap`` spill
    to ``spill_dir`` (default ``<snapshot_dir>/popspill``); 0 = unbounded.
    """

    num_clients: int = 0               # 0 = off; == slots = degenerate; > slots = sampled
    sampler: str = "uniform"           # "uniform" | "weighted" | "skew"
    seed: int = 0                      # the cohort draws' seed
    over_select: float = 1.0           # draw ceil(slots * over_select) candidates
    round_deadline_ms: float = 0.0     # report-latency cut; 0 = no deadline
    min_reports: int = 0               # quorum: fewer reporters discard the round
    quorum_retries: int = 3            # re-draws a round before the abort
    client_state: str = "persist"      # "persist" | "reset"
    resident_cap: int = 0
    spill_dir: str = ""


@dataclass
class ElasticConfig:
    """Elastic membership (``parallel.membership``): the lease and formation
    policy a coordinator worker ships in its join (a service started without
    explicit flags adopts the first joiner's), and its join timeout.
    ``enabled`` records a ``--membership`` run in ``config.json``; set
    without a service, the coordinator refuses it."""

    enabled: bool = False
    lease_ms: float = 15000.0
    heartbeat_ms: float = 5000.0
    formation_grace_ms: float = 10000.0
    min_world: int = 1
    join_timeout_s: float = 180.0


@dataclass
class FedConfig:
    strategy: str = "param_avg"        # "local" | "grad_avg" | "param_avg" | "coordinator"
    num_clients: int = 8
    local_epochs: int = 1              # client epochs per round
    rounds: int = 10                   # global rounds (reference server.py global_epochs)
    participation: float = 1.0         # fraction of clients aggregated per round
    # classic FedAvg weighting by each coordinator process's shard size
    # (McMahan et al.); False = reference parity, the server's unweighted
    # key-wise mean over unequal shards (reference server.py:37-55)
    weight_by_samples: bool = False
    # sequence parallelism: each client's history split over a seq world of
    # this many processes (parallel.mesh.seq_group), the user tower attending
    # across it by ring or Ulysses collectives (parallel.ring). 1 = off
    seq_shards: int = 1
    seq_impl: str = "ring"             # "ring" | "ulysses"
    # the update codec of the round-end sync and the coordinator's wire
    # (comms.codecs): none|int8|sign1bit|topk|countsketch|randproj, or "auto"
    # (a per-leaf map pinned from warm-up telemetry; the trainer only)
    dcn_compress: str = "none"
    dcn_topk_ratio: float = 0.01       # topk: ceil(ratio * n) coordinates a tensor
    dcn_sketch_width: float = 0.1      # sketches: buckets / coordinates, in (0, 1]
    dcn_sketch_seed: int = 0           # the shared sketch hash/projection seed
    # dcn_compress="auto": rounds observed (with the sync running dense)
    # before the per-leaf codec map is pinned. The map derives from the
    # warmup round's global delta, identical on every process.
    dcn_auto_warmup: int = 1
    # per-client error-feedback residuals for the biased codecs (sign1bit, topk)
    dcn_error_feedback: bool = True
    # FedOpt over round deltas (fed.strategies.ServerOptimizer): "none"
    # adopts the client mean (FedAvg); "sgd" with server_momentum > 0 is
    # FedAvgM; "adam" is FedAdam. Needs a strategy that syncs params
    server_opt: str = "none"           # "none" | "sgd" | "adam"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    # Byzantine-robust aggregation + quarantine/rollback recovery (RobustConfig)
    robust: RobustConfig = field(default_factory=RobustConfig)
    # the cross-device cohort engine (PopulationConfig)
    population: PopulationConfig = field(default_factory=PopulationConfig)
    # elastic membership (ElasticConfig, cli.coordinator --membership)
    elastic: ElasticConfig = field(default_factory=ElasticConfig)


@dataclass
class PrivacyConfig:
    """Local DP (``privacy.dpsgd``); the fields and defaults of the JAX
    package's."""

    enabled: bool = False
    epsilon: float = 10.0
    delta: float = 1e-5
    clip_norm: float = 2.0             # C (MAX_GRAD_NORM)
    # if sigma > 0 it overrides the accountant-calibrated value
    sigma: float = 0.0
    accountant_epochs: int = 50        # EPOCHS used for calibration
    # "dpsgd"    - per-example clip + noise on all trainable grads (joint
    #              mode)
    # "ldp_news" - reference parity: noise only on news-embedding grads, no
    #              clipping
    mechanism: str = "dpsgd"
    # "all" | "user" (user tower only; dpsgd only)
    dp_scope: str = "all"


@dataclass
class ShardConfig:
    table: bool = False                # not ported: True raises
    fsdp: int = 1                      # not ported: > 1 raises


@dataclass
class ChaosConfig:
    """Deterministic fault injection (``fed.chaos``): a seeded plan of
    per-round, per-client faults. ``faults`` is a comma list of
    ``kind@round:client[xscale]`` (``round`` may be ``*``): ``nan@2:3``,
    ``scale@*:5x100``, ``flip@4:2``. The host faults act in the coordinator
    deployment; the wire keys are the JAX package's and refused by name
    when set."""

    enabled: bool = False
    seed: int = 0
    drop_rate: float = 0.0             # per-(round, client) Bernoulli dropout
    straggle_rate: float = 0.0         # ditto; weight 0 + optional host delay
    straggle_ms: float = 0.0           # host sleep a round with a straggler
    faults: str = ""                   # "kind@round:client[xscale]" comma list
    # population faults (fed.chaos.population_report), on LOGICAL clients at
    # the cohort draw: each sampled client drops with pop_drop_rate, a seeded
    # pop_flaky_fraction of the population with pop_flaky_drop_rate instead;
    # pop_straggle_ms > 0 draws a lognormal(median pop_straggle_ms, sigma
    # pop_straggle_sigma) report latency, cut at fed.population's deadline
    pop_drop_rate: float = 0.0
    pop_flaky_fraction: float = 0.0
    pop_flaky_drop_rate: float = 0.5
    pop_straggle_ms: float = 0.0
    pop_straggle_sigma: float = 1.0
    # host faults of the coordinator deployment (cli.coordinator): process
    # kill_process exits (137) at the entry of round kill_round; every
    # process truncates its local snapshot of torn_snapshot_round
    kill_round: int = -1
    kill_process: int = -1
    torn_snapshot_round: int = -1
    # elastic membership: the killed worker's one holdoff before it rejoins
    # (fed.chaos.rejoin_holdoff), so the survivors' shrunk epoch runs first
    rejoin_delay_s: float = 0.0
    # wire faults of the async deployment (fed.chaos.WireFaultPlan): a comma
    # list of "kind@start[-end][:arg]" (kinds drop, delay, tear, dup,
    # partition; times in seconds since the proxy started), drawn per
    # (wire_seed, connection index). The run CLI puts a ChaosProxy in front
    # of --agg-server when set (chaos.enabled required); empty: no proxy
    wire_faults: str = ""
    wire_seed: int = 0


@dataclass
class HealthConfig:
    """The numeric sentry (``train.step``) and its monitor (``obs.health``).

    ``sentry`` makes every train step return a per-client health vector
    (grad, update and param global norms, a non-finite flag, the DP
    clip-rate under dpsgd), read once a round. ``abort_on_nonfinite``
    raises ``TrainingHealthError`` on a non-finite cell. The flight-recorder
    fields (``flight_recorder``, ``ring_size``, ``dump_policy``,
    ``snapshot_state``, ``dump_table_max_mb``) need ``obs.dir``; without it
    they are inert, as in the JAX package.
    """

    sentry: bool = True                # per-client health vector in step metrics
    abort_on_nonfinite: bool = True    # raise TrainingHealthError
    flight_recorder: bool = True
    ring_size: int = 16
    dump_policy: str = "first"
    snapshot_state: bool = True
    # loss-spike predicate: a warning when a round's mean loss exceeds
    # spike_factor x the mean of the trailing spike_window rounds; 0 = off
    spike_factor: float = 0.0
    spike_window: int = 8
    # outlier flag: a client whose round-mean update norm exceeds
    # outlier_k x the cohort median; 0 = off
    outlier_k: float = 3.0
    dump_table_max_mb: int = 512
    # the JAX package's XLA recompile watchdog's; the port compiles no XLA
    # programs (obs.device.BuildWatch counts the kernels' nvcc builds): inert
    storm_threshold: int = 5
    storm_window_s: float = 60.0


@dataclass
class QualityConfig:
    """Model-quality observability (``obs.quality``), the JAX package's
    fields and defaults. ``enabled`` turns on the sliced evaluation: the
    full-pool pass also accumulates per-slice ranking metrics (news-category
    hash buckets, history-length buckets, client-activity quantile buckets,
    per-client), score histograms and calibration sums, published as
    ``eval.*{slice=...}`` gauges (``obs.quality.QualityMonitor``). The
    serving CLI arms the store's pre-swap drift probe when ``enabled`` and
    ``probe_users > 0``."""

    enabled: bool = False
    seed: int = 0                      # seeded slice definitions (category hash)
    category_buckets: int = 8          # news-category hash buckets
    hist_len_edges: str = "10,30"      # history-length bucket edges
    activity_buckets: int = 10         # client-activity quantile buckets; 0 = off
    per_client: bool = True            # per-client slices + quality-outlier digest
    ece_bins: int = 10                 # reliability bins over sigmoid(score)
    score_bins: int = 20               # score histogram over [-range, +range]
    score_range: float = 10.0
    outlier_auc_drop: float = 0.05     # quality-outlier AUC drop; 0 = off
    probe_users: int = 32              # drift-probe user vectors; 0 = off
    probe_topk: int = 10


@dataclass
class PerfConfig:
    """Performance observability (``obs.perf.PerfMonitor``), the JAX
    package's fields and defaults: per-round ``perf.mfu`` and throughput
    gauges from the analytic FLOPs model over the H100's peak, a roofline
    verdict from the round's host spans, device-memory attribution by
    component (``hbm_components``: the trainer's own tensors), and capture
    windows (``capture_rounds`` "N" or "N:K", ``capture_drop``) that wrap
    rounds in ``torch.profiler`` with CUDA activity under
    ``obs.dir/perf_capture_rNNNN``. ``compile_cost`` is accepted and inert:
    XLA's ``cost_analysis`` has no counterpart."""

    enabled: bool = False
    compile_cost: bool = True
    hbm_components: bool = True
    capture_rounds: str = ""
    capture_drop: float = 0.0
    capture_window: int = 8


@dataclass
class FleetConfig:
    """Fleet telemetry (``obs.fleet``): ``collector`` is the HOST:PORT of the
    telemetry collector this worker pushes registry snapshots and completed
    spans to every ``push_every`` rounds (standalone, ``python -m
    fedrec_tpu_torch.obs.fleet``, or the membership service's
    ``--telemetry-dir``); "" = the ``obs.dir`` artifacts only. A failed push
    is counted (``obs.fleet_push_failures_total``), never raised."""

    collector: str = ""                # HOST:PORT; "" = offline artifacts only
    push_every: int = 1                # rounds between telemetry pushes
    push_timeout_s: float = 5.0        # per-push TCP deadline


@dataclass
class WireConfig:
    """The wire envelope (``obs.wire``): every JSON-lines exchange carries an
    additive trace-context key (flow arrows across processes, per-edge RTT,
    bytes and clock offsets); ``enabled=false`` sends none, and the bytes
    are the pre-envelope protocol's."""

    enabled: bool = True               # false = the pre-envelope wire, byte for byte
    window: int = 32                   # per-edge offset median window


@dataclass
class SloConfig:
    """Declarative SLOs and burn-rate alerting (``obs.watch``):
    ``objectives`` is a semicolon list of
    ``name:metric[{label=value,...}][:pQQ]OPthreshold[@target]`` over
    metrics the registry publishes (``round_time:train.round_seconds:p95<2.5``);
    an alert fires when the burn rate passes ``fast_burn`` over the last
    ``fast_window`` evaluations and ``slow_burn`` over the last
    ``slow_window``."""

    enabled: bool = False
    objectives: str = ""
    target: float = 0.99
    fast_window: int = 12
    slow_window: int = 60
    fast_burn: float = 14.4
    slow_burn: float = 6.0


@dataclass
class WatchConfig:
    """The alert lifecycle (``obs.alerts``), the anomaly detector and the
    fleet rules (``obs.watch.FleetRules``)."""

    anomaly: bool = True
    anomaly_z: float = 6.0
    anomaly_alpha: float = 0.3
    anomaly_window: int = 32
    anomaly_warmup: int = 8
    pending_for: int = 2
    resolve_after: int = 3
    flap_max: int = 3
    flap_window: int = 20
    history: int = 256
    drift_churn_max: float = 0.5
    fleet_straggler_factor: float = 2.0
    fleet_straggler_evals: int = 3
    fleet_quorum_factor: float = 3.0
    fleet_stalled_pushes: int = 3


@dataclass
class ObsConfig:
    """Telemetry: the registry and tracer always record in memory; ``dir``
    turns on the file artifacts: ``metrics.jsonl`` (per-round records and
    registry snapshots, rotated past ``jsonl_max_mb``), ``trace.json``
    (Chrome-trace host spans), ``prometheus.txt``, and the flight
    recorder's dump under ``flightrec/``. ``fedrec-obs``
    (``fedrec_tpu_torch.cli.obs``) reads them."""

    dir: str = ""                      # "" = no files written
    snapshot_every: int = 1            # rounds between registry snapshots
    trace_capacity: int = 200_000      # host-span ring bound (earliest kept)
    jsonl_max_mb: float = 0.0          # metrics.jsonl rotation size; 0 = unbounded
    health: HealthConfig = field(default_factory=HealthConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
    quality: QualityConfig = field(default_factory=QualityConfig)
    perf: PerfConfig = field(default_factory=PerfConfig)
    wire: WireConfig = field(default_factory=WireConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    watch: WatchConfig = field(default_factory=WatchConfig)


EVAL_PROTOCOLS = ("sampled", "full", "last4")


@dataclass
class AggConfig:
    """Round-end aggregation topology (``agg.*``): "flat" (one reduce),
    "hierarchical" (``tree_fanout``-wide tiers, the ``fed.robust`` method
    applied per tier; with ``mean`` it lowers to the flat reduce, bit for
    bit) or "async" (the buffered quorum commit, ``agg.buffer`` and
    ``agg.commit``: the global commits once ``quorum`` contributions report,
    the later ones fold into the next commit weighted 1 / (1 + staleness)
    and drop past ``staleness_cap`` commits). The ``worker_*`` fields are
    the wire policy of the async deployment's workers (``--agg-server``)."""

    mode: str = "flat"                 # "flat" | "hierarchical" | "async"
    quorum: int = 0                    # async commit quorum; 0 = all-reporting
    staleness_cap: int = 2             # drop buffered updates older than this (commits)
    tree_fanout: int = 2               # hierarchical tier width (>= 2)
    # the async worker's wire policy (agg.worker, parallel.rpc): exchanges
    # retry transport failures with full-jitter backoff inside
    # worker_rpc_attempts; a dead host fails in worker_connect_timeout_s,
    # a slow fold gets worker_timeout_s; past worker_unreachable_budget_s of
    # silence the worker exits 75 for its supervisor
    worker_timeout_s: float = 60.0     # per-exchange read deadline
    worker_connect_timeout_s: float = 5.0   # the dial's deadline
    worker_poll_s: float = 0.2         # sleep between commit polls
    worker_global_wait_s: float = 20.0  # the wait for a newer commit a round
    worker_rpc_attempts: int = 4       # attempts an op
    worker_backoff_ms: float = 50.0    # full-jitter backoff base
    worker_backoff_cap_ms: float = 2000.0   # backoff ceiling a retry
    worker_unreachable_budget_s: float = 120.0  # silence before the rc 75 exit


@dataclass
class TrainConfig:
    """The round loop's cadences (``train.trainer.Trainer``)."""

    save_every: int = 1                # snapshot cadence (reference main.py argv)
    snapshot_dir: str = "snapshots"
    resume: bool = True                # resume from the newest snapshot when one exists
    eval_every: int = 1
    # "sampled" - 1 positive + npratio sampled negatives per impression (the
    #             reference's per-epoch validate, client.py:149-171)
    # "full"    - every negative of the impression's pool (the protocol
    #             behind the published MIND table, evaluation_functions.py:33-47)
    # "last4"   - the pool's last 4 negatives (client.py:159-160)
    eval_protocol: str = "full"
    # keep the best-validation-AUC round's snapshot under <snapshot_dir>/best
    keep_best: bool = False
    seed: int = 42                     # init, dropout streams, participation masks


@dataclass
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    fed: FedConfig = field(default_factory=FedConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    privacy: PrivacyConfig = field(default_factory=PrivacyConfig)
    shard: ShardConfig = field(default_factory=ShardConfig)
    chaos: ChaosConfig = field(default_factory=ChaosConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    agg: AggConfig = field(default_factory=AggConfig)

    def to_dict(self) -> dict[str, Any]:
        """The nested dict ``from_dict`` reads (a flight-recorder manifest's
        ``config``)."""
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ExperimentConfig":
        """The inverse of ``to_json``'s dict (a training run's persisted
        ``config.json``); unknown sections and keys raise ``KeyError``."""
        cfg = cls()
        _merge_dataclass(cfg, d, "")
        return cfg

    def apply_overrides(self, overrides: list[str]) -> "ExperimentConfig":
        """Apply ``section.key=value`` strings (e.g. ``model.news_dim=32``,
        ``obs.health.sentry=0``); unknown sections and keys raise ``KeyError``."""
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"override must be section.key=value, got {item!r}")
            path, raw = item.split("=", 1)
            parts = path.split(".")
            if len(parts) < 2:
                raise ValueError(f"override path must be section.key, got {path!r}")
            section: Any = self
            for part in parts[:-1]:
                section = getattr(section, part, None)
                if section is None or not dataclasses.is_dataclass(section):
                    raise KeyError(f"unknown config section: {path!r}")
            if not hasattr(section, parts[-1]):
                raise KeyError(f"unknown config key: {path!r}")
            current = getattr(section, parts[-1])
            if dataclasses.is_dataclass(current):
                raise KeyError(f"config path {path!r} names a section, not a key")
            setattr(section, parts[-1], _coerce(raw, type(current)))
        return self


def _merge_dataclass(section: Any, values: dict[str, Any], path: str) -> None:
    for key, value in values.items():
        where = f"{path}.{key}" if path else key
        if not hasattr(section, key):
            raise KeyError(f"unknown config key: {where!r}")
        current = getattr(section, key)
        if dataclasses.is_dataclass(current):
            if not isinstance(value, dict):
                raise ValueError(f"config section {where!r} must be a mapping, got {value!r}")
            _merge_dataclass(current, value, where)
        else:
            setattr(section, key, value)


def _coerce(raw: str, ty: type) -> Any:
    if ty is bool:
        low = raw.strip().lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {raw!r}")
    if ty is int:
        return int(raw)
    if ty is float:
        return float(raw)
    return raw
