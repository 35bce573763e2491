"""The federated round loop, the port of ``fedrec_tpu/train/trainer.py``'s
flat path: ``fed.num_clients`` device slots on one card, in joint ("head")
or decoupled ("table", the default) mode over the frozen trunk's cached
token states, or in finetune mode over the token table with the DistilBERT
trunk trained in the loop, with the health sentry, robust aggregation, chaos faults,
quarantine-and-rollback, the cross-device cohort engine
(``fed.population``), FedOpt server optimizers (``fed.server_opt``), the
prefetched data path (``data.prefetch_batches``), the update codecs of the
round-end sync (``fed.dcn_compress``) and the hierarchical robust reduce
(``agg.mode``); no scan chains or rounds-in-jit.

A run is ``fed.rounds`` rounds. A round draws its cohort (with a
population), computes its participation weights, runs ``fed.local_epochs``
epochs of the train step over the slots' batches, takes the strategy's
round-end mean (then the server optimizer's step, with FedOpt), and every
``train.eval_every`` rounds evaluates: the corpus encode (kernel A under
``model.use_pallas``), then the validation impressions under
``train.eval_protocol`` (user vectors from kernel B). ``run`` snapshots
every ``train.save_every`` rounds and at the last, keeps the best-AUC round
under ``train.keep_best``, and resumes from the newest snapshot bitwise.
``export_for_serving`` hands client 0's user tower and news table to
``serving.store`` / ``serve.build_recommend_fn``.

Joint mode: each step runs kernels C, D, B and E under
``model.fuse_hot_path``. Finetune mode: each step runs the batch's distinct
news through every client's ``TextEncoder`` and kernels B and E; the
corpus encode of the evaluation and the export runs the whole encoder over
the (N, 2, L) token table (``train.step.encode_corpus_tokens``), and
snapshots hold the trunk. Decoupled mode: each step trains the user tower
on an (N, news_dim) news-vector table (kernels B and E), and each epoch
ends with the news update (``train.step.build_news_update_step``: kernel
A), after which every client trains its next epoch on client 0's new
table, as in the JAX trainer, also under ``local``. The table is cached:
built at the first epoch from client 0's text head, replaced after each
news update, re-encoded after the round-end mean of a strategy that syncs
parameters and when the clients adopt new global parameters. Evaluation
and the export reuse it; a client other than 0 evaluated on its own (the
clients out of sync) gets a fresh encode of its own head. A restore
happens only in ``__init__``, before the first table is built.

Data. The training set is this process's shard (``data.num_shards`` /
``data.shard_index``, ``data.batcher.process_shard_indices``). In the
fixed world each epoch deals it over the slots (``TrainBatcher``); with a
sampled population slot *j* iterates its logical client's own shard
(``ClientPopulation.cohort_epoch_batches``). Either way the batches come
through ``data.prefetch.maybe_prefetch``: built on a producer thread when
``data.prefetch_batches`` > 0, the same batches either way.

Cohorts. With ``fed.population.num_clients`` above the slot count, a round
draws ``ceil(slots * over_select)`` logical clients (``fed.sampling``),
packs the survivors of the chaos plan's population dropout into the slots
and installs them: every persisted occupant's sidecar (step count,
optimizer states, generator states, the news-gradient accumulator) is
written back to the population's store, then each changed slot loads its
new client's sidecar, or the template on a first selection (zero moments,
step 0, generators seeded from ``(train.seed, client)``). Parameters are
not touched: after the round-end mean every slot holds the global. The
accumulator is zero at every round boundary, so a sidecar carries it as an
empty marker (the full array only if it is not zero). Clients past
``round_deadline_ms`` get weight 0; below ``min_reports`` reporters the
round raises ``QuorumFailure`` before any step and replays with a fresh
draw. A population equal to the slot count is the degenerate world:
identity cohorts, the fixed world's batches, bitwise the run without a
population. The sampler, the ledger, the occupancy and the whole sidecar
store are saved with each snapshot, so a resumed run is the uninterrupted
one bitwise.

FedOpt. The server optimizer steps at round end on the host: client 0's
aggregated parameters come down in one copy, ``ServerOptimizer.step``
moves the round-entry global toward them, and the result goes up in one
copy into every slot. Its buffers are saved with each snapshot.

Health. The train step returns each client's health vector every step
(``obs.health.sentry``, on by default) as device tensors; the round reads
them once, with its losses, and ``obs.health.HealthMonitor`` digests them.
A non-finite cell raises ``TrainingHealthError`` under
``obs.health.abort_on_nonfinite``; a loss spike or an outlier client is a
warning. With ``fed.robust.recover`` a non-finite or outlier client is a
recoverable trigger instead: the client is quarantined (weight 0 for
``fed.robust.quarantine_rounds`` rounds; under sampling the slot's logical
client, excluded from the draws and its sidecar reset), every client is
rolled back to the round-entry state (a device copy of params, optimizer
states, step counts, accumulators and generator states, with the slot
occupancy and the FedOpt buffers) and the round replays, up to
``fed.robust.max_retries`` times; an expired client rejoins healed. The
fixed world's round weights are the participation mask
(``hash((train.seed, round))``, bitwise JAX's) times the chaos plan's
drop/straggle mask times the quarantine exclusion.

Codecs and topology. Under ``fed.dcn_compress`` the round-end sync takes
each client's round-entry parameters and runs the codec over its delta in
Flax layout (``train.step.build_param_sync``), with a per-client
error-feedback residual (``ClientState.ef_residual``: in snapshots, in the
population's sidecars, reset on a heal); one real wire encode of client 0
prices the modeled uplink (``fed.dcn_bytes_up_total`` / ``_down_total``,
``path="cohort"``, ``fed.dcn_compression_ratio`` and ``_leaf``). Under
``agg.mode="hierarchical"`` with a non-mean ``fed.robust`` method, the
clients' parameters come to the host and reduce up an ``agg.tree_fanout``
tree (``agg.tier_reduce_ms``); with ``mean`` the mode is the flat sync.
Under ``agg.mode="async"`` the round ends in the buffered quorum commit
(``_agg_async_commit``): the ``agg.quorum`` earliest reporters (latencies
from the chaos plan's population report) commit now, the later ones' deltas
wait in ``agg_buffer`` and fold into the next commit weighted by their
staleness, dropped past ``agg.staleness_cap``; the buffer and the commit
version are saved with each snapshot (``agg_buffer.npz``).
``_client0_params`` (Flax trees), ``set_global_params``,
``num_local_samples`` and ``adopt_state`` are what the coordinator
deployment (``cli.coordinator``) drives a process's trainer with.

Observability. Metrics go to the ``obs`` registry and a print per round;
the round (``fed_round``, with a ``torch.profiler.record_function`` of the
same round), ``batch_build``, ``h2d``, ``dispatch``, ``aggregate``,
``eval``, rollback and quorum-replay spans to the ``obs`` tracer. With
``obs.dir`` the run writes ``metrics.jsonl`` (a record and a registry
snapshot a round), ``trace.json`` and ``prometheus.txt`` on every exit, and
the flight recorder keeps the round's batches and entry state, dumped on a
health trigger or an exception. ``obs.quality.enabled`` adds the sliced
evaluation, ``obs.perf.enabled`` the MFU and roofline gauges and the
capture windows. ``data.native_loader`` feeds the fixed world from the C++
engine (``data.native_batcher``).

Sequence parallelism (``fed.seq_shards = S > 1``, ``seq_group``): every
rank of a seq world of S processes (``parallel.mesh.seq_group``) runs this
trainer over all K clients with the same seed, so the ranks hold the same
parameters; each step takes the rank's columns of every history
(``parallel.mesh.shard_fed_batch``) through the seq train step, whose
gradient sum keeps them equal. The round's losses and health vectors are
the lead's (rank 0), broadcast, so every rank's health verdicts agree. Rank 0
evaluates the unsharded model (the clients' own modules; the seq view is the
step's) and broadcasts the metrics; it alone prints, logs, snapshots,
writes ``obs.dir``, pushes telemetry and runs the watch. Every rank
restores a snapshot the lead wrote.

``fed.dcn_compress="auto"``: the sync runs an all-"none" map through the
codec body for ``fed.dcn_auto_warmup`` rounds, then ``_pin_auto_codec_map``
picks a codec a leaf from that round's global delta and rebuilds the sync
around it (``codec_map.json`` beside the obs artifacts).

The levers this trainer does not run are refused by name at construction
(``train.step._refuse_unported``).
"""

from __future__ import annotations

import copy
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from fedrec_tpu_torch.agg.buffer import AGG_BUFFER_SIDECAR, AggBuffer, BufferEntry
from fedrec_tpu_torch.agg.commit import CommitPolicy, encode_contribution, fold_commit
from fedrec_tpu_torch.comms.codecs import (
    codec_caps,
    decode_leaf,
    encode_leaf,
    encode_tree,
    leaf_names,
    payload_nbytes,
    tree_dense_nbytes,
    validate_codec,
)
from fedrec_tpu_torch.config import EVAL_PROTOCOLS, ExperimentConfig
from fedrec_tpu_torch.data import (
    IndexedSamples,
    MindData,
    TrainBatcher,
    index_samples,
    maybe_prefetch,
    process_shard_indices,
)
from fedrec_tpu_torch.device import resolve_device, torch_dtype
from fedrec_tpu_torch.eval.metrics import QUALITY_SUM_KEYS
from fedrec_tpu_torch.fed.chaos import FaultPlan, population_report
from fedrec_tpu_torch.fed.population import (
    SIDECAR_FIELDS,
    ClientPopulation,
    QuorumFailure,
    build_cohort_plan,
    plan_round_weights,
)
from fedrec_tpu_torch.fed.robust import validate_robust_method
from fedrec_tpu_torch.fed.sampling import CohortSampler, validate_sampler_mode
from fedrec_tpu_torch.fed.strategies import ServerOptimizer, get_strategy, participation_mask
from fedrec_tpu_torch.models import NewsRecommender
from fedrec_tpu_torch.obs import HealthMonitor, TrainingHealthError, get_registry, get_tracer
from fedrec_tpu_torch.obs.device import BuildWatch, sample_device_memory
from fedrec_tpu_torch.obs.fleet import FleetPusher, ensure_fleet_identity
from fedrec_tpu_torch.obs.health import FlightRecorder
from fedrec_tpu_torch.obs.report import dump_artifacts, rotate_jsonl
from fedrec_tpu_torch.obs.watch import Watch
from fedrec_tpu_torch.obs.wire import configure_wire
from fedrec_tpu_torch.parallel.mesh import check_seq_layout, shard_fed_batch
from fedrec_tpu_torch.parallel.ring import SeqGroup
from fedrec_tpu_torch.params import from_flax, init_params, to_flax
from fedrec_tpu_torch.train.checkpoint import (
    POPULATION_SIDECAR,
    POPULATION_STORE,
    SERVER_OPT_SIDECAR,
    SnapshotManager,
    atomic_write_bytes,
    host_states,
    load_host_states,
    load_population_state,
    population_state_bytes,
)
from fedrec_tpu_torch.train.state import (
    _NOISE_SEED_OFFSET,
    OptState,
    init_client_state,
    replicate_state,
)
from fedrec_tpu_torch.train.step import (
    build_eval_step,
    build_fed_train_step,
    MODES,
    build_full_eval_step,
    build_news_update_step,
    build_param_sync,
    compressed_sync_active,
    contribution_leaves,
    encode_all_news,
    load_contribution,
    encode_corpus_tokens,
)
from fedrec_tpu_torch.utils.logging import MetricLogger

# the model knobs that change the parameter tree: a snapshot written under
# other values cannot load (the text-head family and its conv width shape
# the text head as user_tower shapes the user tower); the trunk's shape the
# tree only in a finetune snapshot, which holds the trunk
_TREE_KNOBS = ("user_tower", "news_dim", "num_heads", "head_dim", "query_dim",
               "text_encoder_mode", "bert_hidden", "text_head_arch", "cnn_kernel")
_TRUNK_KNOBS = ("trunk_layers", "trunk_heads", "trunk_ffn", "trunk_vocab")
_EVAL_BATCH = 256


@dataclass
class RoundResult:
    round_idx: int
    train_loss: float
    val_metrics: dict[str, float] = field(default_factory=dict)


class RoundRecovery(Exception):
    """Internal control flow of quarantine-and-rollback
    (``fed.robust.recover``): raised by the round-end health check instead
    of the abort, caught by the round loop, which quarantines the client,
    restores the round-entry state and replays."""

    def __init__(self, trigger: dict):
        super().__init__(
            f"recoverable health trigger [{trigger.get('kind')}] "
            f"client {trigger.get('client')} round {trigger.get('round')}"
        )
        self.trigger = trigger


class Trainer:
    """Federated trainer over K clients on one device.

    ``token_states``: the (N_news, L, bert_hidden) cached frozen-trunk token
    states (numpy or a tensor), moved to the device once; unused in finetune
    mode (None will do), which moves ``data.news_tokens`` instead. ``snapshot_dir``
    overrides ``train.snapshot_dir``. ``device`` defaults to ``cuda`` and
    raises without a GPU unless ``device="cpu"``.
    """

    def __init__(
        self,
        cfg: ExperimentConfig,
        data: MindData,
        token_states: Any,
        snapshot_dir: str | None = None,
        device: str | torch.device | None = None,
        seq_group: SeqGroup | None = None,
    ):
        self.dev = resolve_device(device)
        self.cfg = cfg
        # a seq world (fed.seq_shards > 1): every rank runs this trainer on
        # all clients with its slice of each history; rank 0 leads
        check_seq_layout(cfg)
        self.seq = seq_group if cfg.fed.seq_shards > 1 else None
        self._is_lead = self.seq is None or self.seq.rank == 0
        if cfg.train.eval_protocol not in EVAL_PROTOCOLS:
            raise ValueError(
                f"unknown train.eval_protocol {cfg.train.eval_protocol!r}; "
                f"expected one of {EVAL_PROTOCOLS}"
            )
        self.strategy = get_strategy(cfg.fed.strategy)
        # robust aggregation and recovery, validated up front: a method or a
        # recovery that would silently never apply is a misconfiguration
        rb = cfg.fed.robust
        validate_robust_method(rb.method)
        if rb.method != "mean" and not self.strategy.sync_params_every_round:
            raise ValueError(
                f"fed.robust.method={rb.method!r} requires a strategy that "
                "syncs params every round (param_avg or coordinator); "
                f"fed.strategy={cfg.fed.strategy!r} never aggregates params, "
                "so the robust aggregator would silently never run"
            )
        if rb.recover:
            if not self.strategy.sync_params_every_round:
                raise ValueError(
                    "fed.robust.recover=true requires a param-syncing "
                    "strategy (param_avg or coordinator): quarantine works "
                    "by zeroing the client's aggregation weight"
                )
            if not cfg.obs.health.sentry:
                raise ValueError(
                    "fed.robust.recover=true requires obs.health.sentry: "
                    "recovery is driven by the in-graph health vectors"
                )
        self._validate_codec_and_topology(cfg)
        # agg.mode="hierarchical" with a non-mean method: the host-side tiered
        # reduce replaces the round-end sync (with mean it lowers to the flat
        # sync, bit for bit)
        self._agg_hier_host = cfg.agg.mode == "hierarchical" and rb.method != "mean"
        # agg.mode="async": the buffered quorum commit replaces the round-end
        # sync; the commit version counts the global's commits
        self._agg_async = cfg.agg.mode == "async"
        self._agg_version = 0
        self.agg_buffer: AggBuffer | None = None
        if self._agg_async:
            self.agg_buffer = AggBuffer()
            self._agg_policy = CommitPolicy(quorum=cfg.agg.quorum,
                                            staleness_cap=cfg.agg.staleness_cap)
        self.server_opt: ServerOptimizer | None = None
        if cfg.fed.server_opt != "none":
            if not self.strategy.sync_params_every_round:
                # the server optimizer steps round deltas at the param sync:
                # under local/grad_avg it would silently never run
                raise ValueError(
                    f"fed.server_opt={cfg.fed.server_opt!r} requires a "
                    "strategy that syncs params every round (param_avg or "
                    f"coordinator); fed.strategy={cfg.fed.strategy!r} never "
                    "would apply it"
                )
            self.server_opt = ServerOptimizer(cfg.fed.server_opt, cfg.fed.server_lr,
                                              cfg.fed.server_momentum)
        self.mode = MODES.get(cfg.model.text_encoder_mode, "joint")
        self.token_states: torch.Tensor | None = None
        self.news_tokens: torch.Tensor | None = None
        if self.mode == "finetune":
            # the trunk trains in the loop: it reads token ids, not cached
            # states (token_states may be None)
            tokens = np.asarray(data.news_tokens)
            if tokens.size and int(tokens[:, 0].max()) >= cfg.model.trunk_vocab:
                raise ValueError(
                    f"the news tokens hold ids >= model.trunk_vocab={cfg.model.trunk_vocab}: "
                    "tokenize with the trunk's vocabulary or raise model.trunk_vocab"
                )
            self.news_tokens = torch.as_tensor(tokens, dtype=torch.int64).to(self.dev)
        else:
            self.token_states = torch.as_tensor(token_states).to(
                self.dev, torch_dtype(cfg.model.dtype))

        train_ix = index_samples(data.train_samples, data.nid2index, cfg.data.max_his_len)
        if cfg.data.num_shards > 1:
            # this process's disjoint shard of the training set
            train_ix = train_ix.take(process_shard_indices(
                len(train_ix), cfg.data.num_shards, cfg.data.shard_index, cfg.data.seed))
        # the true local sample count: what fed.weight_by_samples weighs
        self.num_local_samples = len(train_ix)
        batcher_cls = TrainBatcher
        if cfg.data.native_loader:
            # the C++ engine (built at first use; raises when it cannot be
            # built, where the JAX trainer falls back to the Python batcher)
            from fedrec_tpu_torch.data.native_batcher import NativeTrainBatcher

            batcher_cls = NativeTrainBatcher
        self.batcher = batcher_cls(train_ix, cfg.data.batch_size, cfg.data.npratio,
                                   shuffle=cfg.data.shuffle,
                                   drop_remainder=cfg.data.drop_remainder, seed=cfg.data.seed)
        self.valid_ix: IndexedSamples | None = None
        if data.valid_samples:
            self.valid_ix = index_samples(data.valid_samples, data.nid2index,
                                          cfg.data.max_his_len)
        self.train_ix = train_ix  # the population's shard substrate
        self._setup_population(snapshot_dir)

        model = init_params(NewsRecommender(cfg.model), seed=cfg.train.seed).to(self.dev)
        self.states = replicate_state(init_client_state(model, cfg, cfg.train.seed),
                                      cfg.fed.num_clients, cfg.train.seed + 1)
        self.train_step = build_fed_train_step(model, cfg, self.strategy, mode=self.mode,
                                               device=self.dev, seq_group=self.seq)
        self.news_update = (build_news_update_step(model, cfg, self.strategy, device=self.dev)
                            if self.mode == "decoupled" else None)
        # decoupled mode's news-vector table (client 0's head), built lazily
        self._table: torch.Tensor | None = None
        self.param_sync = build_param_sync(cfg, self.strategy)
        self._sync_takes_entry = compressed_sync_active(cfg, self.strategy)
        self.eval_step = build_eval_step(cfg, device=self.dev)
        self.full_eval_step = build_full_eval_step(device=self.dev)
        self.last_per_client_metrics: list[dict[str, float]] | None = None
        self.data = data
        self._setup_obs(cfg, data)
        self.chaos = FaultPlan(cfg.chaos, cfg.fed.num_clients) if cfg.chaos.enabled else None
        # quarantine ledger: client -> rounds left excluded; retries count the
        # rollbacks of the current round
        self._quarantine: dict[int, int] = {}
        self._round_retries = 0
        self._recovery_state: dict | None = None
        self._m_robust_rounds = self.registry.counter(
            "fed.robust_rounds_total",
            "round-end aggregations performed, labeled by robust method", labels=("method",))
        self._m_quarantines = self.registry.counter(
            "fed.quarantines_total",
            "clients quarantined by the recovery path (weight 0 for "
            "fed.robust.quarantine_rounds rounds)")
        self._m_rollbacks = self.registry.counter(
            "fed.rollbacks_total", "round rollback/replay cycles performed by the recovery path")
        self._g_quarantined = self.registry.gauge(
            "fed.quarantine_active", "clients currently quarantined")
        self._m_chaos = self.registry.counter(
            "chaos.faults_total",
            "faults injected by the chaos FaultPlan, labeled by kind "
            "(drop/straggle/nan/scale/flip); rollback replays re-count", labels=("kind",))
        # the cohort engine's instruments, zero without a population
        self._g_pop_size = self.registry.gauge(
            "fed.population_clients", "configured logical-client population (0 = cross-silo)")
        self._g_pop_size.set(float(cfg.fed.population.num_clients))
        self._g_cohort_sampled = self.registry.gauge(
            "fed.cohort_sampled", "clients drawn for the current round, over-selection included")
        self._g_cohort_reporting = self.registry.gauge(
            "fed.cohort_reporting", "clients whose round weight survived dropout and the deadline")
        self._m_pop_drops = self.registry.counter(
            "fed.pop_dropouts_total", "sampled clients that dropped out of their round")
        self._m_deadline_cuts = self.registry.counter(
            "fed.deadline_cuts_total", "clients cut at the round deadline (weight 0, work discarded)")
        self._m_quorum_replays = self.registry.counter(
            "fed.quorum_replays_total",
            "rounds discarded below min_reports and replayed with a fresh cohort draw")
        self._m_cohort_swaps = self.registry.counter(
            "fed.cohort_slot_swaps_total",
            "device-slot sidecar load/unload operations (cohort churn)")
        self._g_pop_coverage = self.registry.gauge(
            "fed.population_coverage", "fraction of the population selected at least once")
        # FedOpt: the round-entry global on the host, the last one broadcast
        # (None: read client 0 at the next round entry)
        self._global_host: list[np.ndarray] | None = None
        # the communication instruments: bytes by path ("cohort", the modeled
        # uplink of the round-end sync, priced from one real wire encode;
        # "dcn", the coordinator's gather, counted in parallel.multihost)
        self._m_bytes_up = self.registry.counter(
            "fed.dcn_bytes_up_total",
            "client->server round-update bytes shipped, by path (cohort = modeled "
            "round-end uplink, dcn = the coordinator's gather)", labels=("path",))
        self._m_bytes_down = self.registry.counter(
            "fed.dcn_bytes_down_total",
            "server->client fan-out bytes (full precision in every mode), by path",
            labels=("path",))
        self._g_comp_ratio = self.registry.gauge(
            "fed.dcn_compression_ratio",
            "dense/encoded byte ratio of one client's round-update payload under the "
            "active codec")
        self._g_agg_tier_ms = self.registry.gauge(
            "agg.tier_reduce_ms",
            "per-level-max tier-reduce time of the last hierarchical round, summed over "
            "levels (the tree's parallel critical path)")
        # the async commit's instruments, zero under the other modes
        self._m_agg_commits = self.registry.counter(
            "agg.commits_total", "async quorum commits performed (global version bumps)")
        self._m_agg_late = self.registry.counter(
            "agg.late_folds_total", "buffered contributions folded with staleness > 0")
        self._m_agg_stale = self.registry.counter(
            "agg.stale_drops_total", "buffered contributions dropped past agg.staleness_cap")
        self._g_agg_staleness = self.registry.gauge(
            "agg.staleness", "mean staleness (commits behind) of the last commit's folds")
        self._g_agg_version = self.registry.gauge(
            "agg.adopted_version",
            "global model version this worker last adopted (async commit counter; 0 until a "
            "first commit)")
        self._g_agg_quorum_wait = self.registry.gauge(
            "agg.quorum_wait_ms",
            "first-report -> quorum-close time of the last async commit (what the commit "
            "waited, vs the barrier's slowest reporter)")
        self._g_agg_gate_saved = self.registry.gauge(
            "agg.gate_saved_ms",
            "slowest-report latency minus the quorum-close latency of the last async commit "
            "— the barrier wait the quorum removed")
        self._g_agg_pending = self.registry.gauge(
            "agg.buffer_pending", "contributions in the async buffer awaiting a later commit")
        self._codec_bytes_per_client: int | None = None
        self._dense_bytes_per_client: int | None = None
        # fed.dcn_compress="auto": the per-leaf codec map, pinned once after
        # the warm-up window (None while warming up: the sync runs an
        # all-"none" map until the pin, then is rebuilt around the map)
        self._auto_leaf_codecs: list[str] | None = None
        self.auto_codec_pin: dict | None = None
        if cfg.fed.dcn_compress not in ("none", "auto"):
            self._price_codec()

        self.start_round = 0
        self.snapshots: SnapshotManager | None = None
        directory = snapshot_dir or cfg.train.snapshot_dir
        if directory:
            self.snapshots = SnapshotManager(directory)
            if cfg.train.resume and self.snapshots.latest_round() is not None:
                # every rank of a seq world restores the lead's snapshot
                # the incumbent config.json records what the snapshot was
                # trained with: read it before this run's replaces it
                self._check_snapshot_config(cfg)
                try:
                    self.states = self.snapshots.restore(self.states)
                except Exception as e:
                    raise RuntimeError(
                        f"snapshot restore from {self.snapshots.directory} failed "
                        f"({type(e).__name__}; chained below). If it names parameter "
                        "shapes, the model config likely changed since the snapshot was "
                        "written: compare its config.json with this run's --set flags. "
                        "Otherwise point train.snapshot_dir at a fresh directory."
                    ) from e
                # the round that loaded, not latest_round(): a corrupt newest
                # snapshot falls back to the previous retained one
                self.start_round = self.snapshots.last_restored_round + 1
                self._say(f"[trainer] resumed from snapshot at round {self.start_round - 1}")
                self._restore_sidecars(self.snapshots.round_dir(self.start_round - 1))
                # a restored buffer sidecar brought its commit version
                self._g_agg_version.set(float(self._agg_version))
            try:
                if self._is_lead:
                    atomic_write_bytes(self.snapshots.directory / "config.json",
                                       cfg.to_json().encode())
            except OSError as e:
                self._say(f"[trainer] could not persist config.json: {e}")

        self.best_snapshots: SnapshotManager | None = None
        self._best_auc: float | None = None
        if self.snapshots is not None and cfg.train.keep_best and self._is_lead:
            best_dir = self.snapshots.directory / "best"
            self.best_snapshots = SnapshotManager(best_dir, max_to_keep=1)
            marker = best_dir / "best.json"
            if marker.exists():
                # a resumed run: a worse later round never replaces the best
                try:
                    m = json.loads(marker.read_text())
                    best_round, best_auc = int(m["round"]), float(m["auc"])
                except (OSError, ValueError, KeyError, TypeError):
                    best_round = best_auc = None
                stored = self.best_snapshots.latest_round()
                if best_round is not None and stored == best_round:
                    self._best_auc = best_auc
                elif stored is not None or best_round is not None:
                    # torn (a crash between the snapshot and the marker): the
                    # stored round's AUC is unknown; the next improvement
                    # rewrites both
                    self._say("[trainer] best-snapshot marker/round mismatch "
                          f"(marker {best_round}, stored {stored}); best-AUC "
                          "tracking restarts this run")

    def _say(self, *args, **kwargs) -> None:
        """``print``, on the lead rank only (every rank of a seq world runs
        the same rounds)."""
        if self._is_lead:
            print(*args, **kwargs)

    def _validate_codec_and_topology(self, cfg: ExperimentConfig) -> None:
        """The JAX trainer's up-front checks of ``fed.dcn_compress`` (with
        "auto": ``fed.dcn_auto_warmup``) and ``agg.*``, with its wording: a
        codec or a topology that would silently never apply is a
        misconfiguration."""
        rb = cfg.fed.robust
        if cfg.fed.dcn_compress != "auto":
            validate_codec(cfg.fed.dcn_compress)
        if cfg.fed.dcn_compress != "none" and not self.strategy.sync_params_every_round:
            raise ValueError(
                f"fed.dcn_compress={cfg.fed.dcn_compress!r} requires a strategy that syncs "
                "params every round (param_avg or coordinator); "
                f"fed.strategy={cfg.fed.strategy!r} never ships a round update, so the "
                "codec would silently never run (per-step grad_avg traffic is not compressed)"
            )
        if (rb.method != "mean" and cfg.fed.dcn_compress not in ("none", "auto")
                and not codec_caps(cfg.fed.dcn_compress).decodes_per_contribution):
            raise ValueError(
                f"fed.robust.method={rb.method!r} needs per-contribution decode, which codec "
                f"{cfg.fed.dcn_compress!r} cannot provide (its contributions only exist "
                "pre-aggregated: order statistics judge CLIENTS, and sketch collisions mix "
                "every client's coordinates before any decode exists); use one of the "
                "decodable codecs (int8/sign1bit/topk) or fed.robust.method='mean'"
            )
        if cfg.fed.dcn_compress == "auto":
            if rb.method != "mean":
                raise ValueError(
                    "fed.dcn_compress='auto' requires fed.robust.method='mean': the pinned "
                    "per-leaf map may select a linear sketch, whose contributions only exist "
                    "pre-aggregated (no per-contribution decode for order statistics)")
            if cfg.fed.dcn_auto_warmup < 1:
                raise ValueError(
                    f"fed.dcn_auto_warmup={cfg.fed.dcn_auto_warmup} must be >= 1: the per-leaf "
                    "map derives from at least one observed round delta")
            if cfg.shard.fsdp > 1:
                raise ValueError(
                    "fed.dcn_compress='auto' with shard.fsdp>1 is not supported: the pinned map "
                    "may select 'topk', which materializes every gathered dense delta at the "
                    "sync boundary — pin a concrete fsdp-safe codec "
                    "(int8/sign1bit/countsketch/randproj) instead")
        if cfg.agg.mode not in ("flat", "hierarchical", "async"):
            raise ValueError(f"unknown agg.mode {cfg.agg.mode!r}; expected 'flat', "
                             "'hierarchical', or 'async'")
        if cfg.agg.tree_fanout < 2:
            raise ValueError(f"agg.tree_fanout={cfg.agg.tree_fanout} must be >= 2")
        if cfg.agg.staleness_cap < 0:
            raise ValueError(f"agg.staleness_cap={cfg.agg.staleness_cap} must be >= 0")
        if cfg.agg.quorum < 0 or cfg.agg.quorum > cfg.fed.num_clients:
            raise ValueError(
                f"agg.quorum={cfg.agg.quorum} must be in [0, fed.num_clients="
                f"{cfg.fed.num_clients}] (0 = all-reporting)")
        if cfg.agg.mode != "flat" and not self.strategy.sync_params_every_round:
            raise ValueError(
                f"agg.mode={cfg.agg.mode!r} requires a strategy that syncs params every "
                f"round (param_avg or coordinator); fed.strategy={cfg.fed.strategy!r} never "
                "aggregates, so the aggregation topology would silently never apply")
        if cfg.agg.mode == "async" and cfg.fed.dcn_compress == "auto":
            # every concrete codec composes with the buffered commit: linear
            # sketches fold in sketch space, the others decode at push time
            raise ValueError(
                "agg.mode='async' is incompatible with fed.dcn_compress='auto': buffered "
                "entries may outlive the warmup window, so the per-leaf map could change "
                "between a push and its fold — pin a concrete codec (every registered codec "
                "composes: linear sketches fold in sketch space, per-contribution codecs "
                "decode at push time with per-edge error feedback)")

    # ------------------------------------------------------------------
    def _setup_obs(self, cfg: ExperimentConfig, data: MindData) -> None:
        """The observability layer (the JAX trainer's): registry
        instruments and host spans always; under ``obs.dir`` the artifacts
        (``metrics.jsonl`` with its rotation, ``trace.json``,
        ``prometheus.txt``) and the flight recorder; the quality monitor
        under ``obs.quality.enabled``, the perf monitor under
        ``obs.perf.enabled``; the fleet identity and the wire envelope's
        settings always; the telemetry pusher under ``obs.fleet.collector``
        and the watch layer under ``obs.slo.enabled``."""
        self._obs_dir: Path | None = None
        jsonl_path = None
        # a seq world's artifacts, pushes, watch and captures are its lead's
        lead = self._is_lead
        if cfg.obs.dir and lead:
            self._obs_dir = Path(cfg.obs.dir)
            self._obs_dir.mkdir(parents=True, exist_ok=True)
            jsonl_path = str(self._obs_dir / "metrics.jsonl")
        self.registry = get_registry()
        self.tracer = get_tracer()
        self.tracer.capacity = cfg.obs.trace_capacity
        # fleet correlation keys on every span, snapshot and record; the
        # coordinator and run CLIs stamp the stable identity first, and this
        # is then a no-op
        ensure_fleet_identity(worker="0", rank=0)
        configure_wire(enabled=cfg.obs.wire.enabled, window=cfg.obs.wire.window)
        self.logger = MetricLogger(jsonl_path=jsonl_path, registry=self.registry,
                                   jsonl_max_mb=cfg.obs.jsonl_max_mb)
        # round-cadence telemetry to the fleet collector: a failed push is
        # counted, never raised; the obs.dir artifacts stay the offline source
        self.fleet_pusher: FleetPusher | None = None
        if cfg.obs.fleet.collector and lead:
            self.fleet_pusher = FleetPusher(
                cfg.obs.fleet.collector, registry=self.registry, tracer=self.tracer,
                timeout_s=cfg.obs.fleet.push_timeout_s, push_every=cfg.obs.fleet.push_every)
        self._m_rounds = self.registry.counter("train.rounds_total", "federated rounds completed")
        self._m_steps = self.registry.counter("train.steps_total", "train-step batches dispatched")
        self._m_round_loss = self.registry.gauge("train.round_loss",
                                                 "mean train loss of the last round")
        self._m_round_secs = self.registry.histogram(
            "train.round_seconds", "wall seconds per federated round",
            buckets=(0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
                     1000.0))
        self._m_overflow = self.registry.counter(
            "train.cap_overflow_total",
            "unique-news cap overflow count (client-summed over steps; nonzero aborts the round)")
        # the hand-written hot-path kernels a train step launches under
        # model.fuse_hot_path: 2 = C/D and B/E, 1 = B/E only (the CNN head and
        # finetune mode keep the dense gather + encode), 0 = the dense step
        fused_n = 0
        if cfg.model.fuse_hot_path:
            fused_n = 1 + int(cfg.model.text_encoder_mode == "head"
                              and cfg.model.text_head_arch == "additive")
        self.registry.gauge("model.fused_hot_path_kernels",
                            "fused hot-path kernels per train step (0 = dense path)").set(fused_n)
        hcfg = cfg.obs.health
        self.health = HealthMonitor(hcfg, registry=self.registry)
        self.quality = None
        self._slice_defs = None
        self.full_eval_step_q = None
        if cfg.obs.quality.enabled and lead:
            from fedrec_tpu_torch.obs.quality import QualityMonitor

            self.quality = QualityMonitor(cfg.obs.quality, registry=self.registry)
            q = cfg.obs.quality
            self.full_eval_step_q = build_full_eval_step(
                quality=(int(q.score_bins), float(q.score_range), int(q.ece_bins)),
                device=self.dev)
        self.flightrec: FlightRecorder | None = None
        if self._obs_dir is not None and hcfg.flight_recorder:
            self.flightrec = FlightRecorder(ring_size=hcfg.ring_size,
                                            dump_policy=hcfg.dump_policy,
                                            dump_table_max_mb=hcfg.dump_table_max_mb)
        self.perf = None
        self._perf_last_batch: dict | None = None
        if cfg.obs.perf.enabled and lead:
            from fedrec_tpu_torch.obs.perf import PerfMonitor

            name = torch.cuda.get_device_name(self.dev) if self.dev.type == "cuda" else "cpu"
            self.perf = PerfMonitor(cfg.obs.perf, cfg, data.num_news, registry=self.registry,
                                    tracer=self.tracer, obs_dir=self._obs_dir,
                                    device_name=name)
        # the watch layer: SLO burn rates, the anomaly detector and the
        # unified triggers, evaluated once a round with the round's record.
        # Off by default: nothing is built and no alert.* instrument exists
        self.watch: Watch | None = None
        if cfg.obs.slo.enabled and lead:
            self.watch = Watch(cfg.obs.slo, cfg.obs.watch, registry=self.registry,
                               tracer=self.tracer, jsonl_path=jsonl_path,
                               jsonl_max_mb=cfg.obs.jsonl_max_mb)
            if self.perf is not None:
                self.watch.bind_perf(self.perf)
            if self.fleet_pusher is not None:
                # the alert transitions ride the telemetry pushes
                self.fleet_pusher.engine = self.watch.engine
        self.builds = BuildWatch(self.registry)

    def _setup_population(self, snapshot_dir: str | None) -> None:
        """The cohort engine (``fed.population``), validated with the JAX
        trainer's messages. ``_pop_engine``: any population (bookkeeping,
        quorum, deadline); ``_pop_sampling``: a population above the slot
        count (per-client shards, sidecar installs)."""
        cfg = self.cfg
        pcfg = cfg.fed.population
        slots = cfg.fed.num_clients
        self._pop_engine = pcfg.num_clients > 0
        self._pop_sampling = pcfg.num_clients > slots
        self.population: ClientPopulation | None = None
        self.cohort_sampler: CohortSampler | None = None
        self._current_plan = None
        self._pop_pending: dict[int, tuple] = {}
        self._pop_attempts: dict[int, int] = {}
        self.cohort_history: list[tuple[int, tuple]] = []
        self._slot_occupants = np.arange(slots, dtype=np.int64)
        self._slot_writeback = np.ones(slots, bool)
        if not self._pop_engine:
            return
        validate_sampler_mode(pcfg.sampler)
        if pcfg.num_clients < slots:
            raise ValueError(
                f"fed.population.num_clients={pcfg.num_clients} is below "
                f"the device-slot count fed.num_clients={slots}; the population "
                "must cover every slot (== slots is the degenerate cross-silo config)"
            )
        if pcfg.over_select < 1.0:
            raise ValueError(
                f"fed.population.over_select={pcfg.over_select} must be "
                ">= 1.0 (1.0 = no over-selection)"
            )
        if pcfg.client_state not in ("persist", "reset"):
            raise ValueError(
                f"fed.population.client_state={pcfg.client_state!r}; "
                "expected 'persist' or 'reset'"
            )
        if pcfg.min_reports > slots:
            raise ValueError(
                f"fed.population.min_reports={pcfg.min_reports} exceeds "
                f"the slot count {slots}: the quorum could never be met"
            )
        if self._pop_sampling:
            if not self.strategy.sync_params_every_round:
                raise ValueError(
                    "fed.population sampling (num_clients above the slot "
                    "count) requires a param-syncing strategy (param_avg "
                    "or coordinator): sampled-in clients adopt the "
                    f"global at round end; fed.strategy={cfg.fed.strategy!r} "
                    "never distributes one"
                )
            if cfg.fed.participation < 1.0:
                raise ValueError(
                    "fed.participation < 1.0 composes with the FIXED "
                    "cohort only; under fed.population sampling the "
                    "cohort draw IS the participation policy — leave "
                    "fed.participation at 1.0"
                )
        spill = pcfg.spill_dir or None
        if not spill:
            snap = snapshot_dir or cfg.train.snapshot_dir
            spill = str(Path(snap) / "popspill") if snap else None
        if spill and self.seq is not None and self.seq.rank > 0:
            spill = f"{spill}_seq{self.seq.rank}"  # each rank spills its own copies
        self.population = ClientPopulation(
            pcfg.num_clients, len(self.train_ix), data_seed=cfg.data.seed,
            batch_size=cfg.data.batch_size if self._pop_sampling else 0,
            resident_cap=pcfg.resident_cap, spill_dir=spill)
        self.cohort_sampler = CohortSampler(pcfg.num_clients, pcfg.sampler, pcfg.seed,
                                            sample_counts=self.population.sample_counts)

    def _restore_sidecars(self, round_dir: Path) -> None:
        """A resume's FedOpt buffers and cohort-engine state, from the
        restored round's snapshot directory; warns, as the JAX trainer does,
        when one is missing or tagged with another round."""
        restored = self.start_round - 1
        if self.server_opt is not None:
            path = round_dir / SERVER_OPT_SIDECAR
            if not path.exists():
                self._say("[trainer] WARNING: resuming a fed.server_opt run without "
                      f"{path.name} — momentum/adaptivity buffers restart from zero, so the "
                      "resumed trajectory will differ from an uninterrupted one")
            else:
                shapes = [tuple(p.shape) for p in self._slot_params(0)]
                loaded = self.server_opt.load_state(path.read_bytes(), shapes)
                if loaded != restored:
                    self._say(f"[trainer] server_opt sidecar from round {loaded} != snapshot round "
                          f"{restored}; momentum may be skewed for the first resumed round")
        if self._agg_async:
            self._restore_agg_buffer(round_dir / AGG_BUFFER_SIDECAR, restored)
        if not self._pop_engine:
            return
        path = round_dir / POPULATION_SIDECAR
        if not path.exists():
            if self._pop_sampling:
                self._say("[trainer] WARNING: resuming a fed.population run without "
                      f"{path.name} — the sampler/ledger restart fresh, so the resumed "
                      "cohort schedule will differ from an uninterrupted run")
            return
        blob = path.read_bytes()
        loaded = self.adopt_population_sidecar(blob)
        store = load_population_state(blob).get("store")
        if store is not None:
            self.population.load_store(round_dir / POPULATION_STORE, store)
        if loaded != restored:
            self._say(f"[trainer] population sidecar from round {loaded} != snapshot round "
                  f"{restored}; the cohort schedule may be skewed for the first resumed rounds")

    def _restore_agg_buffer(self, path: Path, restored: int) -> None:
        """The pending async contributions and the commit version, from the
        snapshot's buffer sidecar: a missing or unreadable one starts empty
        (late updates are droppable), one of another round keeps its version
        so staleness stays coherent but drops its entries."""
        if not path.exists():
            self._say(f"[trainer] resuming an agg.mode=async run without {path.name} — pending "
                  "late contributions (if any) are lost and the commit version restarts")
            return
        try:
            buf, tag, ver = AggBuffer.load_state(path.read_bytes())
        except ValueError as e:
            self._say(f"[trainer] ignoring unreadable agg-buffer sidecar: {e}")
            return
        self._agg_version = ver
        if tag != restored:
            self._say(f"[trainer] agg-buffer sidecar from round {tag} != snapshot round {restored}; "
                  "starting with an empty buffer (pending late updates dropped)")
            return
        self.agg_buffer = buf
        if len(buf):
            self._say(f"[trainer] restored {len(buf)} pending async contribution(s) at commit "
                  f"version {ver}")

    def population_sidecar_bytes(self, round_idx: int, store: dict | None = None) -> bytes | None:
        """The cohort engine's schedule-defining state (the sampler's
        fairness counters, the participation ledger, the slot occupancy and
        write-back mask, and ``store``, the sidecar store's manifest, when
        given) as bytes, or None without a population."""
        if not self._pop_engine:
            return None
        return population_state_bytes(
            self.cohort_sampler.state_dict(), self.population.ledger.state_dict(),
            self._slot_occupants, self._slot_writeback, round_idx, store)

    def adopt_population_sidecar(self, blob: bytes, resize: bool = False) -> int:
        """Restore the sampler, the ledger and the slot occupancy from
        :meth:`population_sidecar_bytes`; returns its round tag.
        ``resize=True`` adopts a ledger saved under another population
        (prefix copy) and keeps the sampler and the occupancy only where
        their shapes still fit."""
        if not self._pop_engine:
            raise ValueError(
                "adopt_population_sidecar needs an active fed.population "
                "engine (fed.population.num_clients > 0)"
            )
        pst = load_population_state(blob)
        try:
            self.cohort_sampler.load_state_dict(pst["sampler"])
        except ValueError:
            if not resize:
                raise
            self._say("[trainer] population sampler state does not fit the re-formed world; "
                  "fairness counters restart fresh (ledger continuity is preserved)")
        self.population.ledger.load_state_dict(pst["ledger"], resize=resize)
        occ = np.asarray(pst["slot_occupants"], np.int64)
        wb = np.asarray(pst["slot_writeback"], bool)
        if occ.shape == self._slot_occupants.shape:
            self._slot_occupants = occ.copy()
            self._slot_writeback = wb.copy()
        elif not resize:
            raise ValueError(
                f"population sidecar slot count {occ.shape} does not match "
                f"the configured {self._slot_occupants.shape} slots"
            )
        return int(pst["round"])

    def _check_snapshot_config(self, cfg: ExperimentConfig) -> None:
        """A guided error when resuming under a model config whose parameter
        tree cannot match the snapshot's (the raw error names tensor shapes,
        not the knob). Reads the config.json the writing run persisted;
        absent or unreadable, the restore's own structure check decides."""
        try:
            saved = json.loads((self.snapshots.directory / "config.json").read_text())
            saved = saved.get("model", {})
        except (OSError, ValueError):
            return
        knobs = _TREE_KNOBS + (_TRUNK_KNOBS if saved.get("text_encoder_mode") == "finetune"
                               else ())
        diffs = [(k, saved[k], getattr(cfg.model, k))
                 for k in knobs if k in saved and saved[k] != getattr(cfg.model, k)]
        if diffs:
            detail = "; ".join(f"model.{k}: snapshot={s!r} vs this run={c!r}"
                               for k, s, c in diffs)
            raise ValueError(
                f"cannot resume from {self.snapshots.directory}: the snapshot was trained "
                f"under a different model config ({detail}). Re-run with the snapshot's "
                "settings (its config.json has the full record) or point "
                "train.snapshot_dir at a fresh directory."
            )

    def set_global_params(self, user_params: Any, news_params: Any) -> None:
        """Every client adopts the given parameters: Flax-layout numpy trees
        of the user tower and the news tower (the text head, or in finetune
        mode the ``TextEncoder``'s ``{"trunk", "head"}``; ``params.from_flax``).
        Optimizer states and dropout streams stay per client."""
        for st in self.states:
            from_flax(st.model.user_encoder, user_params)
            from_flax(st.model.news_tower, news_params)
        self._global_host = None
        if self.mode == "decoupled":
            self._refresh_table()

    def _client0_params(self) -> tuple[dict, dict]:
        """Client 0's ``(user, news)`` parameters as Flax-layout numpy trees
        (``params.to_flax``): the global after a synced round, what the
        coordinator broadcasts and gathers, and what ``set_global_params``
        takes back."""
        m = self.states[0].model
        return to_flax(m.user_encoder), to_flax(m.news_tower)

    def adopt_state(self, snap: dict) -> None:
        """Install a restored full state (``checkpoint.host_states``' dict:
        every client's parameters, optimizer states, generators and codec
        residual): the coordinator's per-process resume. Cached tables and
        the FedOpt global are re-derived."""
        self.states = load_host_states(self.states, snap)
        self._table = None
        self._global_host = None

    def _price_codec(self) -> None:
        """Price one client's uplink from one real wire encode of client 0's
        contribution (payload sizes are fixed per codec and shapes) and set
        the overall and per-leaf compression-ratio gauges. Run again when
        the "auto" map pins (the payload sizes change with the map)."""
        cfg = self.cfg
        host = self._client0_params()
        enc = encode_tree(host, cfg.fed.dcn_compress, cfg.fed.dcn_topk_ratio,
                          sketch_width=cfg.fed.dcn_sketch_width,
                          sketch_seed=cfg.fed.dcn_sketch_seed,
                          leaf_codecs=self._auto_leaf_codecs)
        self._codec_bytes_per_client = enc.nbytes()
        self._dense_bytes_per_client = tree_dense_nbytes(host)
        self._g_comp_ratio.set(self._dense_bytes_per_client / max(self._codec_bytes_per_client, 1))
        ratio_leaf = self.registry.gauge(
            "fed.dcn_compression_ratio_leaf",
            "dense/encoded byte ratio of one round-update tensor, by leaf", labels=("leaf",))
        for name, payload, shape in zip(leaf_names(host), enc.payloads, enc.shapes):
            dense_b = 4 * int(np.prod(shape)) if shape else 4
            ratio_leaf.set(dense_b / max(payload_nbytes(payload), 1), leaf=name)

    # tensors at or below this size stay uncompressed under "auto":
    # scalars and norm vectors, where a codec's overhead exceeds the bytes
    _AUTO_DENSE_FLOOR = 64

    def _pin_auto_codec_map(self, round_idx: int, sync_entry: list) -> None:
        """``fed.dcn_compress='auto'``: derive the per-leaf codec map from
        the warm-up window's global round delta (client 0's round-entry
        leaves against its post-sync ones: the same on every client and
        every process, so the pin needs no broadcast and replays from the
        seed), rebuild the sync around it, price the uplink again, and
        record the map (``codec_map.json`` beside the obs artifacts, the
        logger's ``dcn_auto_map_pinned`` row, one printed line).

        A leaf of at most ``_AUTO_DENSE_FLOOR`` elements stays "none";
        otherwise the host codecs' reconstruction error on the delta
        decides between ``topk`` (at ``fed.dcn_topk_ratio``) and
        ``countsketch`` (at ``fed.dcn_sketch_width``), ties to topk. The map
        is held for the rest of the run; it is not in the snapshot, so a
        resumed run pins again at its first round, as the JAX trainer does."""
        cfg = self.cfg
        t0 = time.perf_counter()
        entry0 = [x.detach().cpu().numpy() for x in sync_entry[0]]
        post0 = self._contribution_host(0)
        names = leaf_names(self._client0_params())
        chosen: list[str] = []
        detail: list[dict] = []
        for i, (name, p, e) in enumerate(zip(names, post0, entry0)):
            d = np.asarray(p, np.float32) - np.asarray(e, np.float32)
            if d.size <= self._AUTO_DENSE_FLOOR:
                chosen.append("none")
                detail.append({"leaf": name, "codec": "none", "n": int(d.size)})
                continue
            errs = {}
            for cand in ("topk", "countsketch"):
                rec = decode_leaf(
                    encode_leaf(d, cand, cfg.fed.dcn_topk_ratio,
                                sketch_width=cfg.fed.dcn_sketch_width,
                                sketch_seed=cfg.fed.dcn_sketch_seed, leaf_id=i),
                    cand, d.shape, sketch_seed=cfg.fed.dcn_sketch_seed, leaf_id=i)
                errs[cand] = float(np.sqrt(np.mean((rec - d) ** 2)))
            pick = "topk" if errs["topk"] <= errs["countsketch"] else "countsketch"
            chosen.append(pick)
            detail.append({"leaf": name, "codec": pick, "n": int(d.size),
                           "rmse_topk": errs["topk"], "rmse_countsketch": errs["countsketch"]})
        self._auto_leaf_codecs = chosen
        self.param_sync = build_param_sync(cfg, self.strategy, leaf_codecs=chosen)
        self._price_codec()
        summary = {
            "pinned_at_round": int(round_idx),
            "warmup_rounds": int(cfg.fed.dcn_auto_warmup),
            "sketch_width": float(cfg.fed.dcn_sketch_width),
            "sketch_seed": int(cfg.fed.dcn_sketch_seed),
            "topk_ratio": float(cfg.fed.dcn_topk_ratio),
            "map": dict(zip(names, chosen)),
            "detail": detail,
        }
        self.auto_codec_pin = {**summary, "pin_ms": (time.perf_counter() - t0) * 1e3}
        if self._obs_dir is not None:
            with open(self._obs_dir / "codec_map.json", "w") as f:
                json.dump(summary, f, indent=2, sort_keys=True)
        # a JSON string survives the logger's stringification: the report
        # parses it back into its auto_codec_map row
        self.logger.log(round_idx, {
            "dcn_auto_map_pinned": json.dumps(dict(zip(names, chosen)), sort_keys=True)})
        counts: dict[str, int] = {}
        for c in chosen:
            counts[c] = counts.get(c, 0) + 1
        self._say(
            f"[trainer] fed.dcn_compress=auto pinned per-leaf codec map after round "
            f"{round_idx}: " + ", ".join(f"{c}×{k}" for c, k in sorted(counts.items()))
            + (f" (codec_map.json in {self._obs_dir})" if self._obs_dir is not None else ""))

    def _count_uplink(self, weights: np.ndarray) -> None:
        """Bank one synced round's modeled traffic (``path="cohort"``): each
        reporting client ships one encoded update up, every client receives
        one dense fan-out down. No-op without a codec."""
        if self._codec_bytes_per_client is None:
            return
        reporting = int((np.asarray(weights) > 0).sum())
        self._m_bytes_up.inc(float(self._codec_bytes_per_client * reporting), path="cohort")
        self._m_bytes_down.inc(float(self._dense_bytes_per_client * self.cfg.fed.num_clients),
                               path="cohort")

    def _uplink_span_args(self, weights: np.ndarray) -> dict:
        """Byte attributes of the aggregate span under a codec."""
        if self._codec_bytes_per_client is None:
            return {}
        return {"codec": self.cfg.fed.dcn_compress,
                "bytes_up": int(self._codec_bytes_per_client * (np.asarray(weights) > 0).sum()),
                "bytes_down": int(self._dense_bytes_per_client * self.cfg.fed.num_clients)}

    def _agg_hier_sync(self, weights: np.ndarray, round_start_global: list[np.ndarray]) -> None:
        """Hierarchical robust sync (``agg.mode="hierarchical"`` with a
        non-mean method): every client's parameters come to the host as (K,
        ...) stacks in Flax layout, reduce up an ``agg.tree_fanout`` tree
        (``agg.hierarchy.tree_reduce_np``, the method per tier, the
        round-entry global as the fallback), then the FedOpt step when on,
        and every client adopts the result. Nobody reporting keeps local
        parameters."""
        from fedrec_tpu_torch.agg.hierarchy import tree_critical_path_ms, tree_reduce_np

        if float(np.sum(weights)) == 0.0:
            return
        cfg = self.cfg
        per_client = [self._contribution_host(c) for c in range(len(self.states))]
        stacks = [np.stack(cells) for cells in zip(*per_client)]
        stats: dict = {}
        reduced = tree_reduce_np(stacks, weights, cfg.agg.tree_fanout, cfg.fed.robust.method,
                                 trim_k=cfg.fed.robust.trim_k, clip_norm=cfg.fed.robust.clip_norm,
                                 fallback_tree=round_start_global, stats=stats)
        self._g_agg_tier_ms.set(tree_critical_path_ms(stats))
        new = list(reduced)
        if self.server_opt is not None:
            new = self.server_opt.step(round_start_global, new)
        self._adopt_contribution(new)

    def _agg_async_commit(self, round_idx: int, weights: np.ndarray,
                          round_start_global: list[np.ndarray]) -> None:
        """The in-process buffered quorum commit (``agg.mode="async"``):
        each slot's report latency comes from the chaos plan's population
        report (all 0 without ``pop_straggle_ms``), the ``agg.quorum``
        earliest reporters commit now with the buffer's earlier stragglers
        (``agg.commit.fold_commit``), and this round's stragglers' deltas
        wait in the buffer, based on the pre-commit version. Under a codec
        each delta goes through ``encode_contribution`` with its logical
        client's banked residual. Then the FedOpt step, and every client
        adopts the commit. Nobody reporting: no commit."""
        cfg = self.cfg
        part = np.flatnonzero(weights > 0)
        if part.size == 0:
            return
        client_ids = np.asarray(self._slot_occupants)
        _, latency = population_report(self.chaos, round_idx, client_ids)
        latency = np.asarray(latency, np.float64)
        per_client = [self._contribution_host(c) for c in range(len(self.states))]

        k = self._agg_policy.quorum_for(int(part.size))
        order = part[np.argsort(latency[part], kind="stable")]
        on_time, late = order[:k], order[k:]
        quorum_lat = float(latency[order[k - 1]])
        max_lat = float(latency[order[-1]])
        codec = cfg.fed.dcn_compress

        def entry(slot: int) -> BufferEntry:
            wid = str(int(client_ids[slot]))
            leaves = [np.asarray(x - b) for x, b in zip(per_client[slot], round_start_global)]
            ecodec = "none"
            if codec != "none":
                banked = (self.agg_buffer.residual_for(wid) if cfg.fed.dcn_error_feedback
                          else None)
                leaves, ecodec, new_res, _ = encode_contribution(
                    leaves, codec, topk_ratio=cfg.fed.dcn_topk_ratio,
                    sketch_width=cfg.fed.dcn_sketch_width, sketch_seed=cfg.fed.dcn_sketch_seed,
                    residual_leaves=banked)
                if new_res is not None and cfg.fed.dcn_error_feedback:
                    self.agg_buffer.bank_residual(wid, self._agg_version, new_res)
            return BufferEntry(worker=wid, round=round_idx, epoch=self.agg_buffer.epoch,
                               based_on=self._agg_version, weight=float(weights[slot]),
                               arrival_ms=float(latency[slot]), leaves=leaves, codec=ecodec)

        # earlier rounds' stragglers fold into this commit (staleness >= 1);
        # this round's are built before the bump, so their staleness counts
        # from the version their deltas are against
        commit_entries = self.agg_buffer.take_all() + [entry(int(s)) for s in on_time]
        late_entries = [entry(int(s)) for s in late]
        new, stats = fold_commit(
            round_start_global, commit_entries, self._agg_version, self._agg_policy,
            method=cfg.fed.robust.method, trim_k=cfg.fed.robust.trim_k,
            clip_norm=cfg.fed.robust.clip_norm, sketch_seed=cfg.fed.dcn_sketch_seed)
        self._agg_version = stats.version
        self._g_agg_version.set(float(stats.version))
        for e in late_entries:
            self.agg_buffer.add(e)
        self._m_agg_commits.inc()
        self._m_agg_late.inc(float(stats.late_folds))
        self._m_agg_stale.inc(float(stats.stale_drops))
        self._g_agg_staleness.set(stats.mean_staleness)
        self._g_agg_quorum_wait.set(quorum_lat - float(latency[order[0]]))
        self._g_agg_gate_saved.set(max_lat - quorum_lat)
        self._g_agg_pending.set(float(len(self.agg_buffer)))
        if self.server_opt is not None:
            # the commit is a proposal, as the flat mean is
            new = self.server_opt.step(round_start_global, new)
        self._adopt_contribution(new)

    @torch.no_grad()
    def _contribution_host(self, client: int) -> list[np.ndarray]:
        """A client's ``contribution_leaves`` on the host, in one copy."""
        leaves = contribution_leaves(self.states[client])
        flat = torch.cat([x.reshape(-1) for x in leaves]).cpu().numpy()
        return [v.reshape(tuple(x.shape)) for v, x in
                zip(np.split(flat, np.cumsum([x.numel() for x in leaves])[:-1]), leaves)]

    def _adopt_contribution(self, leaves: list[np.ndarray]) -> None:
        """Every client adopts Flax-layout leaves in contribution order."""
        for st in self.states:
            load_contribution(st, leaves)
        self._global_host = None
        if self.mode == "decoupled":
            self._refresh_table()

    def _slot_params(self, client: int) -> list[torch.Tensor]:
        """A client's parameters in the server optimizer's order: the user
        tower's, then the text head's."""
        st = self.states[client]
        return st.user_params() + st.news_params()

    @torch.no_grad()
    def _params_host(self, client: int) -> list[np.ndarray]:
        """A client's parameters on the host, in one device-to-host copy."""
        params = self._slot_params(client)
        flat = torch.cat([p.detach().reshape(-1) for p in params]).cpu().numpy()
        return [v.reshape(p.shape) for v, p in
                zip(np.split(flat, np.cumsum([p.numel() for p in params])[:-1]), params)]

    @torch.no_grad()
    def _adopt_global(self, params: list[np.ndarray]) -> None:
        """Every client adopts ``params`` (host arrays in ``_slot_params``
        order): one host-to-device copy, then a copy into each client. The
        decoupled table is re-encoded, as ``set_global_params`` does."""
        flat = torch.from_numpy(np.concatenate([x.reshape(-1) for x in params])).to(self.dev)
        like = self._slot_params(0)
        parts = [v.view(p.shape) for v, p in zip(flat.split([p.numel() for p in like]), like)]
        for c in range(len(self.states)):
            torch._foreach_copy_(self._slot_params(c), parts)
        self._global_host = params
        if self.mode == "decoupled":
            self._refresh_table()

    def _clients_in_sync(self) -> bool:
        """True when every client holds bitwise-identical parameters (after
        a ``param_avg`` mean, or under ``grad_avg``); one host read."""
        if len(self.states) == 1:
            return True
        ref = list(self.states[0].model.parameters())
        same = [(p == q).all()
                for st in self.states[1:] for p, q in zip(ref, st.model.parameters())]
        return bool(torch.stack(same).all())

    def _encode_states(self, client: int) -> torch.Tensor:
        """The (N, D) news table through ``client``'s news tower: its text
        head over the cached states, or in finetune mode its whole
        ``TextEncoder`` over the token table."""
        model = self.states[client].model
        if self.mode == "finetune":
            return encode_corpus_tokens(model.text_encoder, self.news_tokens, device=self.dev)
        return encode_all_news(model, self.token_states, device=self.dev)

    def _refresh_table(self) -> torch.Tensor:
        self._table = self._encode_states(0)
        return self._table

    def _encode_corpus(self, client: int = 0) -> torch.Tensor:
        """The (N, D) news table of ``client``'s head; in decoupled mode the
        cached table, which the round loop just rebuilt from client 0's
        head (a second corpus encode an eval round would double its cost)."""
        if self.mode == "decoupled" and self._table is not None:
            return self._table
        return self._encode_states(client)

    def _corpus_for(self, client: int) -> torch.Tensor:
        # only decoupled mode caches a (client-0) table that another client
        # must bypass
        if client != 0 and self.mode == "decoupled":
            return self._encode_states(client)
        return self._encode_corpus(client)

    def _feature_table(self) -> torch.Tensor:
        """What the train step reads: the token states in joint mode, the
        token table in finetune mode, the cached news-vector table in
        decoupled mode."""
        if self.mode == "finetune":
            return self.news_tokens
        if self.mode == "joint":
            return self.token_states
        if self._table is None:
            self._refresh_table()
        return self._table

    def _aggregate_eval(self, eval_one: Callable[[int], dict]) -> dict[str, float]:
        """Client 0's metrics when the clients are in sync; otherwise the
        mean of per-client metrics, with the per-client list kept on
        ``last_per_client_metrics``."""
        if self.cfg.fed.num_clients == 1 or self._clients_in_sync():
            self.last_per_client_metrics = None
            return eval_one(0)
        per = [eval_one(c) for c in range(self.cfg.fed.num_clients)]
        self.last_per_client_metrics = per
        return {k: float(np.mean([m[k] for m in per])) for k in per[0]}

    def export_for_serving(self) -> tuple[torch.nn.Module, torch.Tensor]:
        """``(user tower, (N, D) news table)`` of client 0, the inputs of
        ``serving.store.EmbeddingStore.publish`` and
        ``serve.build_recommend_fn``. The tower is a frozen copy, so later
        rounds or a restore do not move a published generation. Warns when the clients have diverged
        (``local``, or a round nobody reported): client 0 is then one
        client's model, not the model."""
        if self.cfg.fed.num_clients > 1 and not self._clients_in_sync():
            self._say("[trainer] WARNING: exporting client 0 for serving while clients hold "
                  "DIVERGED parameters (local strategy or an unsynced round) — run a "
                  "param sync first, or serve per-client models deliberately")
        tower = copy.deepcopy(self.states[0].model.user_encoder).eval().requires_grad_(False)
        return tower, self._encode_corpus(0)

    # ------------------------------------------------------------------
    def _participation(self, round_idx: int) -> np.ndarray:
        """The participation mask, keyed ``hash((train.seed, round)) &
        0x7FFFFFFF`` as the JAX trainer keys its own (the same clients for
        the same seed)."""
        cfg = self.cfg
        return participation_mask(hash((cfg.train.seed, round_idx)) & 0x7FFFFFFF,
                                  cfg.fed.num_clients, cfg.fed.participation)

    def _round_weights(self, round_idx: int) -> np.ndarray:
        """The round's aggregation weights, the JAX trainer's composition:

        * fixed world: the participation mask times the chaos plan's
          drop/straggle mask, with the quarantined clients at 0;
        * cohort engine: the plan's weights (pads, population dropouts and
          deadline cuts at 0, ``plan_round_weights``), times the
          participation mask in the degenerate world, then the same chaos
          mask; the slot quarantine only outside sampling (sampling
          excludes quarantined logical clients at the draw). The ledger's
          events follow the final weights, and a reporting count below
          ``min_reports`` raises :class:`QuorumFailure` here, before any
          step.

        A straggler round sleeps ``chaos.straggle_ms`` on the host."""
        cfg = self.cfg
        plan = self._current_plan if self._pop_engine else None
        events = None
        if plan is not None:
            w, events = plan_round_weights(plan, round_idx, cfg.fed.population.round_deadline_ms,
                                           chaos=self.chaos)
            if round_idx == plan.round_idx and plan.start_dropped.size:
                # the start-drops never reached a slot; the ledger still owes
                # them a dropped round
                events["dropped"] = np.unique(np.concatenate([events["dropped"],
                                                              plan.start_dropped]))
            if cfg.fed.participation < 1.0:
                w = w * self._participation(round_idx)
        else:
            w = self._participation(round_idx)
        if self.chaos is not None:
            rf = self.chaos.round_faults(round_idx)
            w = w * rf.weight_mask
            for kind, count in (("drop", len(rf.dropped)), ("straggle", len(rf.straggled))):
                if count:
                    self._m_chaos.inc(count, kind=kind)
            for kind, _client in rf.injected:
                self._m_chaos.inc(kind=kind)
            if rf.straggled and cfg.chaos.straggle_ms > 0:
                time.sleep(cfg.chaos.straggle_ms / 1e3)
        if not self._pop_sampling:
            for c in self._quarantine:
                if 0 <= c < w.shape[0]:
                    w[c] = 0.0
        if plan is not None:
            # the ledger's truth is the final weights (slot chaos included)
            keep = (w > 0) & plan.slot_real
            events["reported"] = np.unique(plan.slot_clients[keep])
            # a real client whose weight fell to 0 for a reason the
            # population's dice did not see (slot chaos, the participation
            # mask, the slot quarantine) still owes the ledger a dropped round
            lost = (set(np.unique(plan.slot_clients[plan.slot_real & ~keep]).tolist())
                    - set(events["reported"].tolist())
                    - set(np.asarray(events["deadline_cut"]).tolist())
                    - set(np.asarray(events["dropped"]).tolist()))
            if lost:
                events["dropped"] = np.unique(np.concatenate([
                    np.asarray(events["dropped"], np.int64), np.asarray(sorted(lost), np.int64)]))
            self._pop_pending[round_idx] = (plan, events)
            reporting = int(events["reported"].size)
            self._g_cohort_reporting.set(float(reporting))
            mr = cfg.fed.population.min_reports
            if 0 < mr and reporting < mr:
                raise QuorumFailure(plan.round_idx, round_idx, reporting, mr, plan.attempt)
        return w

    # ------------------------------------------------------ the cohort engine
    def _ensure_cohort(self, round_idx: int) -> None:
        """Draw and (under sampling) install the cohort of ``round_idx``.
        Re-entrant: a rollback or quorum replay re-derives the plan (the
        same ``(seed, round, attempt)`` less newly quarantined clients), and
        the install does nothing when the occupancy is unchanged."""
        if not self._pop_engine:
            return
        pcfg = self.cfg.fed.population
        exclude = (self.population.ledger.active_quarantine(round_idx)
                   if self._pop_sampling else ())
        plan = build_cohort_plan(
            self.cohort_sampler, self.cfg.fed.num_clients, round_idx, pcfg.over_select,
            chaos=self.chaos, exclude=exclude, attempt=self._pop_attempts.get(round_idx, 0),
            pack=self._pop_sampling)
        self._current_plan = plan
        self._g_cohort_sampled.set(float(len(plan.sampled)))
        if self._pop_sampling:
            self._install_cohort(plan)

    def _template_sidecar(self, client_id: int) -> dict:
        """The sidecar a first-time (or healed) logical client starts from:
        step 0, zero optimizer moments, generators seeded ``train.seed + 1 +
        2**24 + client`` (disjoint from the slots' ``train.seed + 1 +
        slot``), the accumulator's zero marker."""
        st = self.states[0]
        seed = self.cfg.train.seed + 1 + (1 << 24) + int(client_id)

        def opt(o: OptState) -> list:
            return [np.int64(0), *(np.zeros(tuple(t.shape), np.float32)
                                   for t in (o.mu or []) + (o.nu or []))]

        def gen_state(s: int) -> np.ndarray:
            return torch.Generator(device=self.dev).manual_seed(s).get_state().numpy()

        return {
            "step": np.int64(0),
            "opt_user": opt(st.opt_user),
            "opt_news": opt(st.opt_news),
            "generator": gen_state(seed),
            "noise_generator": (np.zeros(0, np.uint8) if st.noise_generator is None
                                else gen_state(seed + _NOISE_SEED_OFFSET)),
            "news_grad_accum": np.zeros(0, np.float32),
            "ef_residual": ([] if st.ef_residual is None else
                            [np.zeros(tuple(r.shape), np.float32) for r in st.ef_residual]),
        }

    @torch.no_grad()
    def _read_sidecar(self, slot: int) -> dict:
        """Slot ``slot``'s sidecar as host arrays (``SIDECAR_FIELDS``): its
        optimizer moments in one device-to-host copy. A zero (or never
        allocated) news-gradient accumulator becomes the empty marker."""
        st = self.states[slot]
        moments = self._opt_tensors(st)
        flat = (torch.cat([t.detach().reshape(-1) for t in moments]).cpu().numpy()
                if moments else np.zeros(0, np.float32))
        host = iter(v.reshape(t.shape) for v, t in zip(
            np.split(flat, np.cumsum([t.numel() for t in moments])[:-1]), moments))

        def opt(o: OptState) -> list:
            return [np.int64(o.count),
                    *(next(host) for _ in range(len(o.mu or []) + len(o.nu or [])))]

        accum = st.news_grad_accum
        keep = accum is not None and bool(accum.any())
        return {
            "step": np.int64(st.step),
            "opt_user": opt(st.opt_user),
            "opt_news": opt(st.opt_news),
            "generator": st.generator.get_state().numpy(),
            "noise_generator": (np.zeros(0, np.uint8) if st.noise_generator is None
                                else st.noise_generator.get_state().numpy()),
            "news_grad_accum": (accum.cpu().numpy() if keep else np.zeros(0, np.float32)),
            # copies: on the CPU .numpy() would alias the slot's tensors
            "ef_residual": ([] if st.ef_residual is None else
                            [r.to("cpu", copy=True).numpy() for r in st.ef_residual]),
        }

    @torch.no_grad()
    def _write_sidecar(self, slot: int, sidecar: dict) -> None:
        """Load ``sidecar`` into slot ``slot``: the moments in one
        host-to-device copy, into the slot's own tensors."""
        st = self.states[slot]
        moments = self._opt_tensors(st)
        host = [np.asarray(x) for key in ("opt_user", "opt_news") for x in sidecar[key][1:]]
        if [tuple(x.shape) for x in host] != [tuple(t.shape) for t in moments]:
            raise ValueError("the sidecar's optimizer moments do not fit the slot's")
        if moments:
            flat = torch.from_numpy(np.concatenate([x.reshape(-1) for x in host])).to(self.dev)
            torch._foreach_copy_(moments, [v.view(t.shape) for v, t in
                                           zip(flat.split([t.numel() for t in moments]), moments)])
        for key in ("opt_user", "opt_news"):
            o = getattr(st, key)
            setattr(st, key, OptState(int(sidecar[key][0]), o.mu, o.nu))
        st.step = int(sidecar["step"])
        st.generator.set_state(torch.from_numpy(np.array(sidecar["generator"])))
        if st.noise_generator is not None:
            st.noise_generator.set_state(torch.from_numpy(np.array(sidecar["noise_generator"])))
        accum = np.asarray(sidecar["news_grad_accum"])
        if accum.size:
            st.news_grad_accum = torch.from_numpy(accum).to(self.dev)
        elif st.news_grad_accum is not None:
            st.news_grad_accum.zero_()
        if st.ef_residual is not None:
            for r, x in zip(st.ef_residual, sidecar["ef_residual"]):
                r.copy_(torch.from_numpy(np.asarray(x)))

    def _install_cohort(self, plan) -> None:
        """Around the round: write every persisted occupant's sidecar back
        to the store, then load each changed slot's new client (its stored
        sidecar, or the template). Parameters are not touched: after the
        round-end mean every slot holds the global, which is what a
        sampled-in client adopts. Pads load their duplicate's sidecar but
        never write back."""
        slots = self.cfg.fed.num_clients
        persist = self.cfg.fed.population.client_state == "persist"
        new_occ = np.asarray(plan.slot_clients, np.int64)
        new_wb = (plan.slot_real & persist).astype(bool)
        changed = [j for j in range(slots) if self._slot_occupants[j] != new_occ[j]]
        if not changed:
            self._slot_writeback = new_wb
            return
        if persist:
            # every persisted occupant, not only the changed slots: a client
            # can stay at its old slot as a weight-0 pad while it is repacked
            # into another, which must load its freshest sidecar
            for j in range(slots):
                if self._slot_writeback[j]:
                    self.population.put_sidecar(int(self._slot_occupants[j]),
                                                self._read_sidecar(j))
        for j in changed:
            cid = int(new_occ[j])
            sc = self.population.get_sidecar(cid) if persist else None
            self._write_sidecar(j, self._template_sidecar(cid) if sc is None else sc)
        self._m_cohort_swaps.inc(len(changed))
        self._slot_occupants = new_occ.copy()
        self._slot_writeback = new_wb

    def _commit_population(self, round_idx: int) -> None:
        """Commit a completed round into the sampler's fairness state and
        the ledger: only accepted rounds, so rolled-back and
        quorum-discarded rounds never skew the schedule."""
        if not self._pop_engine:
            return
        pending = self._pop_pending.pop(round_idx, None)
        if pending is None:
            return
        plan, events = pending
        self.cohort_sampler.record(plan.sampled)
        self.population.ledger.commit(plan.sampled, events)
        for key, ctr in (("dropped", self._m_pop_drops),
                         ("deadline_cut", self._m_deadline_cuts)):
            n = int(np.asarray(events.get(key, ())).size)
            if n:
                ctr.inc(n)
        self._pop_attempts.pop(round_idx, None)
        self._g_pop_coverage.set(self.population.ledger.coverage())
        if self._pop_sampling:
            self._g_quarantined.set(float(len(self.population.ledger.quarantined)))
        self.cohort_history.append(
            (round_idx, tuple(int(c) for c in plan.slot_clients[plan.slot_real])))

    def _handle_quorum_failure(self, e: QuorumFailure, round_idx: int) -> None:
        """One quorum replay: drop the round's pending ledger events, bump
        the anchor round's draw attempt (a fresh cohort and fresh dice),
        abort once the retries are spent. The failure comes before any
        step, so the round's entry state was never left. A replay that no
        attempt counter can change (the degenerate world without population
        dice) aborts at once."""
        pcfg = self.cfg.fed.population
        self._pop_pending = {k: v for k, v in self._pop_pending.items() if k < round_idx}
        attempts = self._pop_attempts.get(e.anchor_round, 0) + 1
        self._m_quorum_replays.inc()
        self.tracer.add_span("quorum_replay", dur_s=0.0, round=e.round_idx,
                             reporting=e.reporting, attempt=attempts)
        ch = self.cfg.chaos
        attempt_sensitive = self._pop_sampling or (
            self.chaos is not None
            and (ch.pop_drop_rate > 0 or ch.pop_flaky_fraction > 0
                 or (ch.pop_straggle_ms > 0 and pcfg.round_deadline_ms > 0)))
        if attempts > pcfg.quorum_retries or not attempt_sensitive:
            futile = ("" if attempt_sensitive else
                      " (a fixed-world cohort with no population-level fault "
                      "dice replays identically — retries skipped)")
            raise RuntimeError(
                f"round {e.round_idx} failed quorum "
                f"({e.reporting} reporting < min_reports="
                f"{pcfg.min_reports}) on {attempts} consecutive cohort "
                f"draws{futile} — the population's dropout rate cannot "
                "sustain this quorum. Lower fed.population.min_reports, "
                "raise over_select, or relax the deadline "
                "(docs/OPERATIONS.md, 'sizing a cohort')."
            ) from e
        self._pop_attempts[e.anchor_round] = attempts
        self._say(f"[trainer] WARNING: quorum failure at round {e.round_idx} "
              f"({e.reporting} < {pcfg.min_reports}); discarding the round "
              f"and replaying with a fresh cohort draw (attempt {attempts}/"
              f"{pcfg.quorum_retries})")

    @staticmethod
    def _round_loss_mean(mean_cells: np.ndarray, loss_cells: np.ndarray) -> float:
        """The flat mean of the per-step client means; when one is not
        finite (a NaN client poisons its step's mean), the mean of the
        finite per-client cells."""
        mean_cells = mean_cells.reshape(-1)
        if np.isfinite(mean_cells).all():
            return float(mean_cells.mean())
        loss_cells = loss_cells.reshape(-1)
        finite = loss_cells[np.isfinite(loss_cells)]
        return float(finite.mean()) if finite.size else float("nan")

    def _overflow_message(self, total: int) -> str:
        cfg = self.cfg
        policy = (f"data.unique_news_cap_buckets={cfg.data.unique_news_cap_buckets!r}"
                  if cfg.data.unique_news_cap_buckets
                  else f"data.unique_news_cap={cfg.data.unique_news_cap}")
        return (f"{policy} overflowed on {total} step(s) this round — the capped "
                "unique-news dedup dropped ids and the gradients are invalid. Raise the "
                "cap (or set it to 0 for the exact worst-case bound).")

    def train_round(self, round_idx: int) -> RoundResult:
        """One round: the cohort (with a population), the local epochs, the
        round-end aggregate (and the FedOpt step), one host read of the
        round's losses and health vectors, the health check, then the
        evaluation when due."""
        t0 = time.perf_counter()
        # the cohort first: the draw and the install define who the round is
        self._ensure_cohort(round_idx)
        if self.perf is not None:
            self.perf.begin_round()
        # the host span and a profiler range of the same round number, so a
        # CUDA trace captured around it lines up with trace.json
        with self.tracer.span("fed_round", step_num=round_idx, **self._round_span_args()), \
                torch.profiler.record_function(f"fed_round#{round_idx}"):
            result = self._train_round_inner(round_idx)
            # device-memory gauges at the round boundary, as an instant
            # inside this fed_round span; a no-op on the CPU
            sample_device_memory(self.registry, self.tracer, self.dev, fed_round=round_idx)
            self._perf_sample_components(round_idx)
        wall = time.perf_counter() - t0
        self._m_round_secs.observe(wall)
        self.builds.publish()
        if self.perf is not None:
            self.perf.observe_round(round_idx, 1, wall)
        return result

    def _perf_sample_components(self, round_idx: int) -> None:
        """``obs.perf.hbm_components``: the device bytes of the trainer's
        own tensors by component, at the round boundary."""
        if self.perf is None or not self.cfg.obs.perf.hbm_components:
            return
        from fedrec_tpu_torch.obs.perf import hbm_components

        hbm_components({
            "params": [p for st in self.states for p in st.model.parameters()],
            "optimizer": [t for st in self.states for t in self._opt_tensors(st)]
                         + [st.news_grad_accum for st in self.states
                            if st.news_grad_accum is not None],
            "news_table": [t for t in (self.token_states, self.news_tokens, self._table)
                           if t is not None],
            "batch": list((self._perf_last_batch or {}).values()),
        }, registry=self.registry, tracer=self.tracer, fed_round=round_idx)

    def _epoch_batches_source(self, epoch_idx: int):
        """One local epoch's stacked (slots, B, ...) batches: the fixed
        world deals the training set over the slots; under sampling slot
        *j* iterates the current cohort's client *j*'s own shard."""
        if self._pop_sampling:
            return self.population.cohort_epoch_batches(
                self._current_plan.slot_clients, self.train_ix, self.cfg.data, epoch_idx)
        return self.batcher.epoch_batches_sharded(self.cfg.fed.num_clients, epoch_idx)

    def _epoch_batch_iter(self, epoch_idx: int, extra: dict | None = None):
        """The epoch's batches as step-ready dicts (``extra``, the round's
        chaos fault vectors, merged into each), built ahead on a producer
        thread when ``data.prefetch_batches`` > 0."""
        extra = extra or {}
        return maybe_prefetch(
            self._epoch_batches_source(epoch_idx), self.cfg.data.prefetch_batches,
            transform=lambda b: {"candidates": b.candidates, "history": b.history,
                                 "labels": b.labels, **extra})

    def _train_round_inner(self, round_idx: int) -> RoundResult:
        cfg = self.cfg
        # a QuorumFailure leaves here, before anything of the round is built
        weights = self._round_weights(round_idx)
        faults = self.chaos.batch_keys(round_idx) if self.chaos is not None else {}
        # FedOpt's round-entry global: the last broadcast, or client 0's
        # parameters (every client holds the global at round entry); the
        # hierarchical reduce's is in Flax layout, its fallback
        round_start_global = None
        if self._agg_hier_host or self._agg_async:
            round_start_global = self._contribution_host(0)
        elif self.server_opt is not None:
            if self._global_host is None:
                self._global_host = self._params_host(0)
            round_start_global = self._global_host
        # the codec sync compresses round deltas: each client's entry params
        host_topology = self._agg_hier_host or self._agg_async
        sync_entry = ([contribution_leaves(st) for st in self.states]
                      if self._sync_takes_entry and not host_topology else None)
        if self.flightrec is not None:
            # replay starts from the state the round's steps saw
            self.flightrec.start_chunk(
                round_idx,
                host_states(self.states, round_idx) if cfg.obs.health.snapshot_state else None,
                {round_idx: weights})
        means, losses, overflow = [], [], 0
        health: dict[str, list] = {}
        tracer = self.tracer
        step_in_round = 0
        for local_epoch in range(cfg.fed.local_epochs):
            epoch_idx = round_idx * cfg.fed.local_epochs + local_epoch
            table = self._feature_table()
            it = self._epoch_batch_iter(epoch_idx, faults)
            src = iter(it)
            try:
                while True:
                    # the consumer-side wait: the batch build itself without
                    # prefetch, what prefetch did not hide with it
                    t_build = tracer.now()
                    try:
                        batch = next(src)
                    except StopIteration:
                        break
                    tracer.add_span("batch_build", dur_s=tracer.now() - t_build,
                                    epoch=epoch_idx)
                    if self.flightrec is not None:
                        self.flightrec.record(batch, round_idx, epoch_idx, step_in_round)
                    step_in_round += 1
                    # under a seq world, this rank's columns of each history
                    batch = shard_fed_batch(batch, self.seq)
                    with tracer.span("h2d", epoch=epoch_idx):
                        batch = {k: (torch.as_tensor(v).to(self.dev)
                                     if k in ("candidates", "history", "labels") else v)
                                 for k, v in batch.items()}
                    if self.perf is not None:
                        self._perf_last_batch = {k: batch[k] for k in
                                                 ("candidates", "history", "labels")}
                    with tracer.span("dispatch", epoch=epoch_idx):
                        self.states, metrics = self.train_step(self.states, batch, table)
                    self._m_steps.inc()
                    means.append(metrics["mean_loss"])
                    losses.append(metrics["loss"])
                    overflow += metrics["unique_overflow"]
                    for k, v in metrics.items():
                        if k.startswith("health."):
                            health.setdefault(k, []).append(v)
            finally:
                # a step that raises must not leak the producer thread
                close = getattr(it, "close", None)
                if close is not None:
                    close()
            if self.mode == "decoupled":
                self.states, tables = self.news_update(self.states, self.token_states)
                self._table = tables[0]
        if self.strategy.sync_params_every_round and host_topology:
            # the host-side topologies replace the round-end sync
            with self.tracer.span("aggregate", round=round_idx, method=cfg.fed.robust.method,
                                  mode=cfg.agg.mode, **self._uplink_span_args(weights)):
                if self._agg_async:
                    self._agg_async_commit(round_idx, weights, round_start_global)
                else:
                    self._agg_hier_sync(weights, round_start_global)
            self._m_robust_rounds.inc(method=cfg.fed.robust.method)
            self._count_uplink(weights)
        elif self.strategy.sync_params_every_round:
            with self.tracer.span("aggregate", round=round_idx, method=cfg.fed.robust.method,
                                  **self._uplink_span_args(weights)):
                if sync_entry is not None:
                    self.states = self.param_sync(self.states, weights, sync_entry)
                else:
                    self.states = self.param_sync(self.states, weights)
            self._m_robust_rounds.inc(method=cfg.fed.robust.method)
            self._count_uplink(weights)
            if (cfg.fed.dcn_compress == "auto" and self._auto_leaf_codecs is None
                    and sync_entry is not None and round_idx + 1 >= cfg.fed.dcn_auto_warmup):
                self._pin_auto_codec_map(round_idx, sync_entry)
            if self.server_opt is not None:
                # FedOpt: the mean is a proposal; the server optimizer steps
                # the global from the round-entry one toward it
                with self.tracer.span("server_opt", round=round_idx, kind=cfg.fed.server_opt):
                    new = self.server_opt.step(round_start_global, self._params_host(0))
                    self._adopt_global(new)
            elif self.mode == "decoupled":
                self._refresh_table()
        # one host read of the round's losses and health vectors
        mean_cells, loss_cells, arrays = self._read_round(means, losses, health, self.seq)
        train_loss = self._round_loss_mean(mean_cells, loss_cells)
        # the sentry first: a non-finite cell is the root cause to report
        # before any other abort describes the same round
        self._check_health(round_idx, arrays, [train_loss])
        if overflow > 0:
            self._m_overflow.inc(overflow)
            raise RuntimeError(self._overflow_message(overflow))
        result = RoundResult(round_idx, train_loss)
        self._eval_if_due(result)
        return result

    @staticmethod
    def _read_round(means: list, losses: list, health: dict[str, list],
                    seq: SeqGroup | None = None):
        """The round's per-step mean losses (S,), per-client losses (S, K)
        and health vectors as (1, S, K) numpy arrays, from one device-to-host
        copy. Under a seq world every rank takes the lead's (the ranks'
        candidate encodes may differ in the last bits), so every rank's
        health verdicts agree."""
        s = len(means)
        keys = sorted(health)
        flat = torch.cat([torch.stack(means).reshape(-1), torch.stack(losses).reshape(-1),
                          *(torch.stack(health[k]).reshape(-1).float() for k in keys)])
        if seq is not None:
            flat = seq.broadcast(flat)
        host = flat.cpu().numpy()
        k = (host.size - s) // (s * (1 + len(keys))) if s else 0
        cells = host[s:].reshape(1 + len(keys), 1, s, k)
        arrays = {key: cells[1 + i] for i, key in enumerate(keys)}
        if "health.nonfinite" in arrays:
            arrays["health.nonfinite"] = arrays["health.nonfinite"].astype(np.int32)
        return host[:s], cells[0, 0], arrays

    # ------------------------------------------------------ health, recovery
    def _check_health(self, round_idx: int, arrays: dict, round_losses: list) -> None:
        """Digest the round's health arrays through the ``HealthMonitor``.
        Under ``fed.robust.recover`` a non-finite or outlier client raises
        ``RoundRecovery`` while retries remain; otherwise a trigger dumps the
        flight recorder (``obs.dir``), then a non-finite cell raises
        ``TrainingHealthError`` under ``abort_on_nonfinite``, and any other
        trigger is a warning. The JAX trainer's semantics."""
        if not self.cfg.obs.health.sentry or not arrays:
            return
        trigger = self.health.check(round_idx, arrays, list(round_losses),
                                    ignore_clients=set(self._quarantine))
        if self.watch is not None:
            # the health verdicts pulse through the alert engine, scored at
            # the round's evaluation
            self.watch.ingest_health_trigger(trigger)
            self.watch.ingest_health_outliers(self.health.last_outliers)
        rb = self.cfg.fed.robust
        if rb.recover:
            cand = trigger if trigger is not None and trigger.get("kind") == "nonfinite" else None
            if cand is None and self.health.last_outliers:
                cand = {"kind": "outlier",
                        **max(self.health.last_outliers, key=lambda o: o["update_norm"])}
            if (cand is not None and cand.get("client") is not None
                    and self._round_retries < rb.max_retries):
                raise RoundRecovery(cand)
        if trigger is None:
            return
        dump_dir = self._dump_flightrec(trigger)
        kind = trigger["kind"]
        where = f"round {trigger.get('round')}"
        if trigger.get("step") is not None:
            where += f" step {trigger['step']} client {trigger.get('client')}"
        detail = trigger.get("detail") or {
            k: trigger[k] for k in ("round_loss", "trailing_mean") if k in trigger}
        if dump_dir:
            hint = (f" Forensics dumped to {dump_dir} — confirm with "
                    f"`python -m fedrec_tpu_torch.cli.obs replay {dump_dir}`.")
        elif self.flightrec is not None:
            hint = (" Flight-recorder dump suppressed by "
                    f"obs.health.dump_policy={self.cfg.obs.health.dump_policy!r} "
                    f"(earlier dump: {self.flightrec.last_dump_dir}).")
        else:
            hint = " Set obs.dir (+ obs.health.flight_recorder) for a replayable dump."
        msg = f"training-health trigger [{kind}] at {where}: {detail}.{hint}"
        if kind == "nonfinite" and self.cfg.obs.health.abort_on_nonfinite:
            raise TrainingHealthError(msg)
        self._say(f"[trainer] WARNING: {msg}")

    def _dump_meta(self) -> dict:
        return {"num_news": self.data.num_news, "title_len": self.data.title_len,
                "mode": self.mode}

    def _dump_flightrec(self, trigger: dict):
        """The flight recorder's dump for ``trigger`` (None without a
        recorder, or when its dump policy suppressed a repeat). The feature
        table goes in when it fits ``obs.health.dump_table_max_mb``; a
        failing dump is reported, never raised over the trigger."""
        if self.flightrec is None:
            return None
        try:
            return self.flightrec.dump(self._obs_dir / "flightrec", trigger, cfg=self.cfg,
                                       registry=self.registry, table=self._feature_table(),
                                       meta=self._dump_meta())
        except Exception as e:  # noqa: BLE001 — forensics must not mask the trigger
            self._say(f"[trainer] flight-recorder dump failed: {type(e).__name__}: {e}")
            return None

    def _flightrec_on_exception(self, e: BaseException) -> None:
        """A run dying to an exception that never reached a round-end health
        check (a step error, a cap-overflow abort) still dumps its batch
        ring and round-entry state."""
        if self.flightrec is None or self.flightrec.dump_count > 0:
            return
        if not isinstance(e, Exception):
            return  # KeyboardInterrupt / SystemExit: exit fast, no dump
        self._dump_flightrec({"kind": "exception", "error": type(e).__name__,
                              "message": str(e)[:500], "round": None, "step": None})

    def _round_span_args(self) -> dict:
        args: dict = {}
        if self._quarantine:
            args["quarantined"] = sorted(self._quarantine)
        if self._pop_sampling and self._current_plan is not None:
            args["cohort"] = int(self._current_plan.slot_real.sum())
            if self.population.ledger.quarantined:
                args["quarantined"] = sorted(self.population.ledger.quarantined)
        if self._round_retries:
            args["replay_retry"] = self._round_retries
        if self._codec_bytes_per_client is not None:
            # what one client's update costs on the wire under the codec
            args["codec"] = self.cfg.fed.dcn_compress
            args["codec_bytes_per_client"] = self._codec_bytes_per_client
            args["dense_bytes_per_client"] = self._dense_bytes_per_client
        return args

    @staticmethod
    def _opt_tensors(st) -> list[torch.Tensor]:
        return [t for o in (st.opt_user, st.opt_news) for t in (o.mu or []) + (o.nu or [])]

    @torch.no_grad()
    def _capture_recovery_state(self) -> None:
        """The rollback target at round entry (``fed.robust.recover`` only):
        a device copy of every client's parameters and optimizer moments
        (one flat buffer a client, one launch), its optimizer counts, step
        count, news-gradient accumulator and generator states, and the
        cached decoupled table (replaced, never written in place, so a
        reference is its copy); with a population the slot occupancy and
        write-back mask (a replay re-installs against the restored slots),
        with FedOpt its buffers and round-entry global (a replay must not
        apply the momentum twice)."""
        if not self.cfg.fed.robust.recover:
            return
        self._recovery_state = {
            "clients": [{
                "flat": torch.cat([t.detach().reshape(-1) for t in
                                   [*st.model.parameters(), *self._opt_tensors(st)]]),
                "counts": (st.opt_user.count, st.opt_news.count),
                "step": st.step,
                "generator": st.generator.get_state(),
                "noise_generator": (None if st.noise_generator is None
                                    else st.noise_generator.get_state()),
                "news_grad_accum": (None if st.news_grad_accum is None
                                    else st.news_grad_accum.clone()),
                "ef_residual": (None if st.ef_residual is None
                                else [r.clone() for r in st.ef_residual]),
            } for st in self.states],
            "table": self._table,
            "occupancy": (self._slot_occupants.copy(), self._slot_writeback.copy()),
            "server_opt": (None if self.server_opt is None
                           else copy.deepcopy(self.server_opt._state)),
            "global_host": self._global_host,
        }

    @torch.no_grad()
    def _restore_recovery_state(self) -> None:
        for st, saved in zip(self.states, self._recovery_state["clients"]):
            params = list(st.model.parameters())
            like = params + self._opt_tensors(st)
            # a fresh copy: a second rollback of the round restores again
            parts = saved["flat"].clone().split([t.numel() for t in like])
            parts = [v.view(t.shape) for v, t in zip(parts, like)]
            torch._foreach_copy_(params, parts[:len(params)])
            moments = iter(parts[len(params):])
            for which, count in zip(("opt_user", "opt_news"), saved["counts"]):
                o = getattr(st, which)
                mu = None if o.mu is None else [next(moments) for _ in o.mu]
                nu = None if o.nu is None else [next(moments) for _ in o.nu]
                setattr(st, which, OptState(count, mu, nu))
            st.step = saved["step"]
            st.generator.set_state(saved["generator"])
            if saved["noise_generator"] is not None:
                st.noise_generator.set_state(saved["noise_generator"])
            accum = saved["news_grad_accum"]
            st.news_grad_accum = None if accum is None else accum.clone()
            if saved["ef_residual"] is not None:
                st.ef_residual = [r.clone() for r in saved["ef_residual"]]
        saved = self._recovery_state
        self._table = saved["table"]
        self._slot_occupants, self._slot_writeback = (x.copy() for x in saved["occupancy"])
        if self.server_opt is not None:
            self.server_opt._state = copy.deepcopy(saved["server_opt"])
        self._global_host = saved["global_host"]

    def _rollback_and_quarantine(self, trigger: dict, round_idx: int) -> None:
        """One recovery cycle: quarantine the offending client, restore the
        round-entry state; the caller replays the round. Counted in the
        registry and stamped into the trace as a ``rollback`` span."""
        rb = self.cfg.fed.robust
        client = int(trigger["client"])
        kind = str(trigger.get("kind"))
        self._round_retries += 1
        logical = None
        if self._pop_sampling and self._current_plan is not None:
            # the sentry flags a slot; quarantine the logical client in it:
            # the sampler skips it until the expiry round, and its (possibly
            # poisoned) sidecar is reset, so it rejoins from the template
            logical = int(self._current_plan.slot_clients[client])
            self.population.ledger.quarantine(logical, round_idx + rb.quarantine_rounds)
            self.population.reset_sidecar(logical)
            self._pop_pending = {k: v for k, v in self._pop_pending.items() if k < round_idx}
            self._g_quarantined.set(float(len(self.population.ledger.quarantined)))
        else:
            self._quarantine[client] = max(self._quarantine.get(client, 0),
                                           rb.quarantine_rounds)
            self._g_quarantined.set(float(len(self._quarantine)))
        self._m_quarantines.inc()
        self._m_rollbacks.inc()
        t0 = time.perf_counter()
        self._restore_recovery_state()
        if logical is not None:
            # its sidecar was reset above: the replay's install must not
            # write the restored slot copy back
            self._slot_writeback[self._slot_occupants == logical] = False
        self.tracer.add_span("rollback", dur_s=time.perf_counter() - t0,
                             round=int(trigger.get("round") or round_idx),
                             client=client if logical is None else logical,
                             kind=kind, retry=self._round_retries)
        who = f"client {client}" if logical is None else f"logical client {logical} (slot {client})"
        self._say(f"[trainer] WARNING: health trigger [{kind}] on {who} at round "
              f"{trigger.get('round')} — quarantining it for {rb.quarantine_rounds} round(s), "
              f"rolling back to the round-{round_idx} entry state and replaying (retry "
              f"{self._round_retries}/{rb.max_retries})")

    def _tick_quarantine(self) -> None:
        """Advance the quarantine ledger by one completed round; an expired
        client rejoins healed (params reset to the global, optimizer state
        zeroed): its own state may still hold NaN, and un-healed Adam
        moments would trip the same quarantine again."""
        if not self._quarantine:
            return
        expired = []
        for c in list(self._quarantine):
            self._quarantine[c] -= 1
            if self._quarantine[c] <= 0:
                expired.append(c)
                del self._quarantine[c]
        self._g_quarantined.set(float(len(self._quarantine)))
        for c in expired:
            self._heal_client(c)

    @torch.no_grad()
    def _heal_client(self, client: int) -> None:
        donor = next((c for c in range(self.cfg.fed.num_clients)
                      if c != client and c not in self._quarantine), None)
        if donor is None:
            return
        st = self.states[client]
        for p, q in zip(st.model.parameters(), self.states[donor].model.parameters()):
            p.copy_(q)
        for which in ("opt_user", "opt_news"):
            o = getattr(st, which)
            setattr(st, which, OptState(
                0, None if o.mu is None else [torch.zeros_like(m) for m in o.mu],
                None if o.nu is None else [torch.zeros_like(v) for v in o.nu]))
        if st.news_grad_accum is not None:
            st.news_grad_accum.zero_()
        if st.ef_residual is not None:
            # a healed client must not replay a poisoned codec residual
            for r in st.ef_residual:
                r.zero_()
        if client == 0:
            self._global_host = None  # FedOpt reads client 0 afresh
        if self.mode == "decoupled":
            self._table = None  # the parameters changed: rebuild lazily
        self._say(f"[trainer] quarantine expired for client {client}: rejoined with global "
              "params and fresh optimizer state")

    def _train_round_with_recovery(self, round_idx: int) -> RoundResult:
        """``train_round`` under the quarantine-and-rollback policy (the
        round-entry capture, and a replay after each recoverable trigger)
        and the quorum policy (a replay with a fresh draw after each
        ``QuorumFailure``). Without either, exactly ``train_round``."""
        while True:
            self._capture_recovery_state()
            try:
                result = self.train_round(round_idx)
            except RoundRecovery as e:
                self._rollback_and_quarantine(e.trigger, round_idx)
                continue
            except QuorumFailure as e:
                self._handle_quorum_failure(e, round_idx)
                continue
            self._round_retries = 0
            return result

    def train_round_recovering(self, round_idx: int) -> RoundResult:
        """One round under the quarantine-and-rollback and quorum policies,
        then the population's commit and the quarantine ledger's tick (the
        JAX trainer's per-round entry point of the same name)."""
        result = self._train_round_with_recovery(round_idx)
        self._commit_population(round_idx)
        self._tick_quarantine()
        return result

    def _eval_if_due(self, result: RoundResult) -> None:
        """Round-cadence evaluation (``train.eval_every``). Under a seq world
        the lead evaluates the unsharded model (the clients' own modules: the
        seq view is the train step's) and every rank takes its metrics."""
        if self.valid_ix is None or (result.round_idx + 1) % self.cfg.train.eval_every != 0:
            return
        if self.seq is not None:
            if self._is_lead:
                self._eval_now(result)
            result.val_metrics = self._share_metrics(result.val_metrics)
            return
        self._eval_now(result)

    def _share_metrics(self, metrics: dict[str, float]) -> dict[str, float]:
        """The lead's metric dict on every rank of the seq world (its JSON
        bytes, length first)."""
        blob = torch.tensor(list(json.dumps(metrics).encode()) if self._is_lead else [],
                            dtype=torch.uint8)
        n = self.seq.broadcast(torch.tensor([blob.numel()], dtype=torch.int64))
        if not self._is_lead:
            blob = torch.zeros(int(n[0]), dtype=torch.uint8)
        return json.loads(bytes(self.seq.broadcast(blob).tolist()).decode())

    def _eval_now(self, result: RoundResult) -> None:
        protocol = self.cfg.train.eval_protocol
        with self.tracer.span("eval", round=result.round_idx, protocol=protocol):
            # sliced telemetry rides the full-pool protocols only: the sampled
            # protocol re-draws negatives, so its slices would carry noise
            q = None
            if self.quality is not None and protocol in ("full", "last4"):
                q = self._begin_quality_eval()
            if protocol == "full":
                result.val_metrics = self.evaluate_full(_quality=q)
            elif protocol == "last4":
                result.val_metrics = self.evaluate_full(last_k=4, _quality=q)
            else:
                result.val_metrics = self.evaluate()
            if q is not None:
                self._finish_quality_eval(result.round_idx, q, result.val_metrics)

    def _begin_quality_eval(self) -> dict:
        """One sliced-eval session: the slice accumulator (the definitions
        built once a run, seeded) and the score/calibration partial sums the
        eval loop folds batches into."""
        from fedrec_tpu_torch.obs.quality import SlicedEvalAccumulator, build_slice_defs

        if self._slice_defs is None:
            self._slice_defs = build_slice_defs(self.valid_ix, self.cfg.obs.quality)
        return {"acc": SlicedEvalAccumulator(self._slice_defs, len(self.valid_ix)), "sums": {}}

    def _finish_quality_eval(self, round_idx: int, q: dict,
                             val_metrics: dict[str, float]) -> None:
        """Publish the session: per-slice gauges (and the skip counter), the
        corpus quartet under ``slice="all"``, the score/calibration digest,
        and the per-client quality-outlier digest (informational)."""
        slices, skipped = q["acc"].finalize()
        # a diverged cohort pooled every client's pass into the session: the
        # means are invariant, the counts and sums are x passes
        passes = max(int(q.get("passes", 1)), 1)
        if passes > 1:
            for m in slices.values():
                m["count"] /= passes
            q["sums"] = {k: v / passes for k, v in q["sums"].items()}
        self.quality.publish_slices(slices, skipped)
        # the category family partitions the scoreable impressions
        kept = sum(m["count"] for n, m in slices.items()
                   if n.startswith("category=")) or float(len(self.valid_ix))
        self.quality.publish_corpus(val_metrics, count=kept)
        if q["sums"]:
            self.quality.publish_distribution(q["sums"])
        if self.cfg.obs.quality.per_client:
            self.health.last_quality_outliers = self.quality.digest_clients(
                round_idx, self.last_per_client_metrics,
                ignore_clients=set(self._quarantine), shared=val_metrics)
            if self.watch is not None:
                self.watch.ingest_quality_outliers(self.health.last_quality_outliers)

    def evaluate(self, client: int | None = None) -> dict[str, float]:
        """Mean validation metrics over all impressions of 1 positive +
        ``npratio`` sampled negatives (the reference's per-epoch validate,
        ``client.py:149-171``), batches of up to 256 with the last batch's
        wrap-around padding trimmed. ``client=None`` resolves the target as
        ``_aggregate_eval`` does."""
        if self.valid_ix is None:
            raise ValueError("no validation samples")
        if client is None:
            return self._aggregate_eval(lambda c: self.evaluate(client=c))
        user = self.states[client].model.user_encoder
        table = self._corpus_for(client)
        n = len(self.valid_ix)
        bsz = min(n, _EVAL_BATCH)
        vb = TrainBatcher(self.valid_ix, batch_size=bsz, npratio=self.cfg.data.npratio,
                          shuffle=False, drop_remainder=False, seed=0)
        sums: dict[str, float] = {}
        count = 0
        for batch in vb.epoch_batches(0):
            out = self.eval_step(user, table, {"candidates": batch.candidates,
                                               "history": batch.history,
                                               "labels": batch.labels})
            valid_n = min(bsz, n - count)  # trim the wrap-around pad rows
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + float(v[:valid_n].sum())
            count += valid_n
        return {k: v / count for k, v in sums.items()}

    def evaluate_full(self, last_k: int | None = None, client: int | None = None,
                      _quality: dict | None = None) -> dict[str, float]:
        """Deterministic evaluation over each impression's full negative
        pool (the protocol behind the reference's published MIND table);
        ``last_k`` keeps each pool's last k negatives (``last_k=4`` is the
        reference client's per-round slice, ``client.py:159-160``).
        Impressions with an empty pool are skipped, as the reference's
        try/except does; padding is masked out of every mean. ``client``
        resolves as in :meth:`evaluate`. ``_quality``
        (``_begin_quality_eval``'s session) routes the pass through the
        quality-instrumented step and folds each batch into the slice
        accumulator and the score/calibration sums."""
        if self.valid_ix is None:
            raise ValueError("no validation samples")
        if client is None:
            return self._aggregate_eval(
                lambda c: self.evaluate_full(last_k=last_k, client=c, _quality=_quality))
        user = self.states[client].model.user_encoder
        table = self._corpus_for(client)

        ix = self.valid_ix
        n = len(ix)
        pools = ix.neg_pools
        lens = ix.neg_lens.astype(np.int64)
        if last_k is not None:
            # each pool's last k real negatives, left-aligned
            p = min(last_k, pools.shape[1])
            start = np.maximum(lens - p, 0)[:, None]
            idx = np.minimum(start + np.arange(p)[None, :], pools.shape[1] - 1)
            pools = np.take_along_axis(pools, idx, axis=1)
            lens = np.minimum(lens, p)
        width = max(1, pools.shape[1])
        mask = (np.arange(width)[None, :] < lens[:, None]).astype(np.float32)

        bsz = min(n, _EVAL_BATCH)
        pad = (-n) % bsz

        def _pad(a):
            return np.concatenate([a, np.repeat(a[:1], pad, axis=0)]) if pad else a

        pos_a = _pad(ix.pos)
        pools_a = _pad(pools.astype(np.int32))
        mask_a = _pad(mask)
        his_a = _pad(ix.history)
        keep_a = _pad((lens > 0).astype(np.float32))
        if pad:
            keep_a[n:] = 0.0  # padded rows never count
        step = self.full_eval_step if _quality is None else self.full_eval_step_q
        if _quality is not None:
            # one pass per evaluated client: the session divides the pooled
            # counts back down
            _quality["passes"] = _quality.get("passes", 0) + 1
        sums = {k: 0.0 for k in ("auc", "mrr", "ndcg5", "ndcg10")}
        kept = 0.0
        for b in range(0, n + pad, bsz):
            sl = slice(b, b + bsz)
            batch = {"pos": pos_a[sl], "neg_pools": pools_a[sl], "neg_mask": mask_a[sl],
                     "history": his_a[sl]}
            if _quality is not None:
                batch["keep"] = keep_a[sl]
            out = step(user, table, batch)
            w = torch.from_numpy(keep_a[sl]).to(self.dev)
            for k in sums:
                sums[k] += float((out[k] * w).sum())
            kept += float(keep_a[sl].sum())
            if _quality is not None:
                _quality["acc"].add(b, {k: out[k].cpu().numpy() for k in sums}, keep_a[sl])
                qs = _quality["sums"]
                for k in QUALITY_SUM_KEYS:
                    qs[k] = qs.get(k, 0.0) + out[k].double().cpu().numpy()
        if kept == 0:
            raise ValueError("no impression has a non-empty negative pool")
        return {k: v / kept for k, v in sums.items()}

    # ------------------------------------------------------------------
    def run(self) -> list[RoundResult]:
        """Rounds ``start_round`` .. ``fed.rounds - 1`` under the
        quarantine-and-rollback policy, each followed by its snapshot
        bookkeeping and the quarantine tick; returns the rounds' results."""
        history = []
        try:
            for round_idx in range(self.start_round, self.cfg.fed.rounds):
                if self.perf is not None:
                    # a capture window opens before the round it wraps
                    self.perf.capture_before_round(round_idx)
                result = self._train_round_with_recovery(round_idx)
                history.append(result)
                # before the snapshot: its population state includes this round
                self._commit_population(round_idx)
                self._after_round(result)
                self._tick_quarantine()
                if self.perf is not None:
                    # closes after the round's bookkeeping, which it captures
                    self.perf.capture_after_round(round_idx)
            if self.snapshots is not None:
                self.snapshots.wait()  # settle the writes before handing back
        except BaseException as e:
            # forensics on every failing exit: an error that never reached a
            # round-end health check still dumps the ring
            self._flightrec_on_exception(e)
            raise
        finally:
            if self.perf is not None:
                self.perf.close()
                self._perf_last_batch = None
            if self._obs_dir is not None:
                # on every exit path: a run that died is the one whose
                # trace and registry are needed
                try:
                    paths = dump_artifacts(self._obs_dir, registry=self.registry,
                                           tracer=self.tracer)
                    self._say(f"[trainer] obs artifacts: {paths['metrics']} {paths['trace']} "
                          f"{paths['prometheus']}")
                except Exception as e:  # noqa: BLE001 — never mask the training error
                    self._say(f"[trainer] could not write obs artifacts: {type(e).__name__}: {e}")
            if self.fleet_pusher is not None:
                # on every exit path; never raises (a dead collector counts
                # a failure)
                self.fleet_pusher.push(final=True)
        return history

    def _after_round(self, result: RoundResult) -> None:
        """The round's log line, the best-AUC snapshot and the cadence
        snapshot."""
        cfg = self.cfg
        r = result.round_idx
        self._m_rounds.inc()
        self._m_round_loss.set(result.train_loss)
        log = {"round": r, "training_loss": result.train_loss}
        m = result.val_metrics
        log.update({name: m[key] for name, key in (
            ("validation_loss", "loss"), ("val_auc", "auc"), ("val_mrr", "mrr"),
            ("val_ndcg5", "ndcg5"), ("val_ndcg10", "ndcg10")) if key in m})
        self._say(f"[trainer] {json.dumps(log)}", flush=True)
        if self.perf is not None and self.perf.last_round is not None:
            # the round's digest rides its record: the trend fedrec-obs perf reads
            log.update({k: v for k, v in self.perf.last_round.items() if k != "round"})
        self.logger.log(r, log)
        auc = m.get("auc")
        if (self.best_snapshots is not None and auc is not None
                and (self._best_auc is None or auc > self._best_auc)):
            # a failed best-write must not end training, nor advance the best
            try:
                # blocking: the marker never names a snapshot still in flight
                self.best_snapshots.save(r, self.states, wait=True)
                best = self.best_snapshots.directory
                atomic_write_bytes(best / "best.json",
                                   json.dumps({"round": r, "auc": float(auc)}).encode())
                atomic_write_bytes(best / "config.json", cfg.to_json().encode())
                self._best_auc = float(auc)
            except OSError as e:
                self._say(f"[trainer] could not persist best snapshot at round {r}: {e}")
        if self.snapshots is not None and (
            (r + 1) % cfg.train.save_every == 0 or r == cfg.fed.rounds - 1
        ):
            # blocking under FedOpt or the cohort engine: their files pair
            # with this snapshot and read live state
            extras = (self._snapshot_extras(r)
                      if self.server_opt is not None or self._pop_engine or self._agg_async
                      else None)
            if self._is_lead:  # a seq world's ranks hold the same state
                self.snapshots.save(r, self.states, wait=extras is not None, extras=extras)
        if self._obs_dir is not None and (r + 1) % max(cfg.obs.snapshot_every, 1) == 0:
            # rotate before the append: snapshots are the event log's bulk
            rotate_jsonl(self._obs_dir / "metrics.jsonl", cfg.obs.jsonl_max_mb)
            self.registry.write_snapshot(self._obs_dir / "metrics.jsonl")
        if self.watch is not None:
            # one tick a round, before the push, so this round's transitions
            # ride this round's push
            self.watch.evaluate(record=log)
        if self.fleet_pusher is not None:
            self.fleet_pusher.maybe_push(r)

    def _snapshot_extras(self, round_idx: int) -> Callable[[Path], None]:
        """The files a snapshot holds beside its state: the FedOpt buffers,
        the async buffer with its commit version, and the cohort engine's
        state with (under sampling) the whole sidecar store, all tagged with
        ``round_idx``."""
        def write(directory: Path) -> None:
            if self.server_opt is not None:
                atomic_write_bytes(directory / SERVER_OPT_SIDECAR,
                                   self.server_opt.state_bytes(round_idx))
            if self._agg_async:
                atomic_write_bytes(directory / AGG_BUFFER_SIDECAR,
                                   self.agg_buffer.state_bytes(round_idx, self._agg_version))
            if self._pop_engine:
                store = (self.population.save_store(directory / POPULATION_STORE)
                         if self._pop_sampling else None)
                atomic_write_bytes(directory / POPULATION_SIDECAR,
                                   self.population_sidecar_bytes(round_idx, store))
        return write
