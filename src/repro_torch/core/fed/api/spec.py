"""``FedSpec`` — the one declarative federation config both stacks share.

A spec says WHAT federation to run: the substrate ("quantum" |
"classical"), the Alg. 1/2 shape (N, N_p, I_l), the strategy names
(aggregation / participation / channel / round schedule / server-side
outer optimizer — each validated against its shared registry at
construction, so a typo fails before any tracing, in ``from_json`` as
much as in direct construction), the substrate-specific knobs, and an
optional DATA RECIPE
that lets ``make_substrate`` rebuild the exact training data from the
spec alone (which is what makes a checkpointed federation resumable
from nothing but the checkpoint file).

Specs travel: ``to_json``/``from_json`` round-trip losslessly, so a
spec rides inside checkpoint metadata and ``--spec`` CLI files. The
legacy per-stack config types (``QuantumFedConfig``,
``FederatedConfig``) remain as deprecated shims with lossless
converters both ways.

This is the port of ``repro.core.fed.api.spec``: the same fields,
defaults, validation messages, JSON and ``fingerprint``, so one spec
file means the same federation in both packages. Validation runs
through the port's own registries. ``impl`` keeps the names ``"xla"``
(plain PyTorch, complex128) and ``"pallas"`` (the port's hand-written
CUDA kernels).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.core.fed import channel as fchannel
from repro_torch.core.fed import participation, strategies
from repro_torch.core.fed.config import FederatedConfig

SPEC_VERSION = 1
SUBSTRATES = ("quantum", "classical")

# fields whose JSON lists must come back as tuples
_TUPLE_FIELDS = ("widths", "node_sizes")

# fields that do NOT key a serving group (``fingerprint``): traced
# hyperparameters and data CONTENT. Everything structural — widths,
# cohort shape, strategy names, engine/impl/rank knobs, node sizes —
# stays in the key, so two specs with equal fingerprints trace to the
# SAME compiled round and their sessions can run stacked (data shapes
# are pinned by num_nodes / n_per_node / node_sizes / widths; seeds,
# noise ratio and iid-ness only change array VALUES).
_NON_GROUPING_FIELDS = ("eta", "eps", "server_momentum", "data_seed",
                        "data_noise", "data_iid", "latency_seed",
                        "latency_model", "latency_mu", "latency_sigma",
                        "latency_alpha", "latency_trace",
                        "n_test", "eval_batch",
                        # fault/deadline knobs perturb the TIMELINE, not
                        # the compiled round (fault/deadline sessions run
                        # sequentially in serve anyway); the defense
                        # knobs stay grouping — they change the
                        # aggregate computation itself
                        "fault_model", "fault_rate", "fault_seed",
                        "fault_scale", "fault_trace", "round_deadline",
                        "max_retries", "retry_backoff",
                        "min_participants")


@dataclasses.dataclass(frozen=True)
class FedSpec:
    """Declarative federation spec (see module docstring).

    Construct through ``FedSpec.quantum(...)`` / ``FedSpec.classical(...)``
    — they pick the right defaults for the substrate; direct construction
    validates identically.
    """
    substrate: str
    # --- Alg. 1/2 shape + shared strategy names ------------------------
    num_nodes: int = 2            # N
    nodes_per_round: int = 2      # N_p
    interval_length: int = 1      # I_l
    aggregation: str = "average"      # strategy registry
    participation: str = "uniform"    # schedule registry
    participation_method: str = "auto"    # "auto" | "dense" | "sampled"
    dropout_rate: float = 0.0
    # --- aggregation-tree topology (cohort registry) -------------------
    topology: str = "flat"            # "flat" | "two_level"
    pods: Optional[int] = None        # two_level: pod count
    pod_assignment: str = "block"     # "block" | "strided"
    # --- round scheduling (scheduler registry) -------------------------
    schedule: str = "sync"            # "sync" | "async" | "overlapped"
    async_commit: Optional[int] = None    # K: commit when K uploads land
    staleness_decay: float = 0.5      # async weight decay per commit
    latency_seed: int = 0             # async simulated-latency streams
    # --- latency model (cohort.latency registry; async timeline) -------
    latency_model: str = "counter"    # counter | lognormal | pareto | trace
    latency_mu: float = 0.0           # lognormal location
    latency_sigma: float = 0.5        # lognormal scale (> 0)
    latency_alpha: float = 1.5        # pareto tail index (> 1)
    latency_trace: Optional[str] = None   # trace: path to a trace file
    # --- robust aggregation defenses (strategies.DEFENSES) -------------
    defense: Optional[str] = None     # clip | trimmed_mean | median | screen
    trim_frac: float = 0.2            # trimmed_mean: trim fraction/side
    clip_norm: float = 1.0            # clip: per-matrix Frobenius bound
    screen_tol: float = 0.05          # screen: allowed fidelity drop
    # --- fault injection (faults registry) -----------------------------
    fault_model: Optional[str] = None     # crash | stale | corrupt |
    #                                       sign_flip | scale | slow | trace
    fault_rate: float = 0.0           # Bernoulli rate of the draw models
    fault_seed: int = 0               # fault stream seed
    fault_scale: float = 3.0          # Byzantine coeff / slow multiplier
    fault_trace: Optional[str] = None     # trace: fault schedule file
    # --- deadline/retry semantics (sync + async schedulers) ------------
    round_deadline: Optional[float] = None    # sim-time upload deadline
    max_retries: int = 2              # re-dispatch attempts per round
    retry_backoff: float = 2.0        # deadline multiplier per retry
    min_participants: int = 1         # survivors needed to commit
    # --- server-side outer optimizer (server_opt registry) -------------
    server_opt: str = "none"          # "none" | "momentum" | "nesterov"
    server_momentum: float = 0.9
    # --- channel -------------------------------------------------------
    quantize_bits: Optional[int] = None   # channel registry: "quantize"
    # --- quantum substrate --------------------------------------------
    widths: Optional[Tuple[int, ...]] = None
    eta: float = 1.0
    eps: float = 0.1
    minibatch: Optional[int] = None
    upload_noise: float = 0.0     # channel registry: >0 => "hermitian"
    engine: str = "local"
    impl: str = "xla"
    fanout: str = "auto"
    # certified approximate rank (engine="local" only): SVD-truncated
    # ensembles with a per-round error certificate (see qnn docs)
    rank_tol: float = 0.0
    rank_cap: Optional[int] = None
    ensemble_dtype: Optional[str] = None  # None | "f32" | "bf16"
    # --- classical substrate ------------------------------------------
    arch: Optional[str] = None    # model config name (configs)
    n_layers: Optional[int] = None  # reduced(n_layers=...) override
    lr: float = 3e-3              # inner (node) learning rate
    outer_lr: float = 1.0
    delta_dtype: str = "float32"
    node_batch: int = 4           # per-node batch per local step
    node_pool_seqs: Optional[int] = None  # per-node sequences per round
    seq_len: int = 64
    # --- data recipe (lets make_substrate rebuild the data) -----------
    data_seed: int = 0
    data_iid: bool = False
    data_noise: float = 0.0       # quantum pair pollution ratio
    n_per_node: Optional[int] = None   # quantum pairs per node
    node_sizes: Optional[Tuple[int, ...]] = None  # unequal quantum nodes
    n_test: int = 32
    eval_batch: int = 8           # classical eval batch size

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.substrate not in SUBSTRATES:
            raise ValueError(f"unknown substrate {self.substrate!r}; "
                             f"registered: {list(SUBSTRATES)}")
        # fail-loud registry validation at construction time
        from repro_torch.core.fed import faults as ffaults
        from repro_torch.core.fed import server_opt as fserver_opt
        from repro_torch.core.fed.api import scheduler as fscheduler
        from repro_torch.core.fed.cohort import latency as flatency
        from repro_torch.core.fed.cohort import topology as ftopology

        agg = strategies.get_aggregation(self.aggregation)
        strategies.validate_defense(self.defense, agg.combine)
        participation.validate(self.participation)
        participation.validate_method(self.participation_method)
        fchannel.resolve_channel(self.upload_noise, self.quantize_bits)
        fscheduler.validate_schedule(self.schedule)
        fserver_opt.validate(self.server_opt)
        ftopology.validate_topology(
            self.topology, self.pods, self.pod_assignment,
            nodes_per_round=self.nodes_per_round, combine=agg.combine,
            schedule=self.schedule, async_commit=self.async_commit)
        flatency.validate_spec(self)
        ffaults.validate_spec(self)
        if self.defense == "trimmed_mean" and not (
                0.0 < self.trim_frac < 0.5):
            raise ValueError(f"trim_frac must be in (0, 0.5) — trimming "
                             f"half per side leaves nothing — got "
                             f"{self.trim_frac}")
        if self.defense == "clip" and not self.clip_norm > 0.0:
            raise ValueError(f"clip_norm must be > 0, got {self.clip_norm}")
        if self.defense == "screen" and not self.screen_tol >= 0.0:
            raise ValueError(f"screen_tol must be >= 0, got "
                             f"{self.screen_tol}")
        if (self.defense in ("trimmed_mean", "median")
                and self.topology != "flat"):
            raise ValueError(
                f"defense {self.defense!r} needs every upload at the "
                "server (order statistics do not decompose over pod "
                "partial sums) — topology='flat' only")
        if self.round_deadline is not None and not self.round_deadline > 0:
            raise ValueError(f"round_deadline must be > 0, got "
                             f"{self.round_deadline}")
        if self.schedule == "overlapped" and (
                self.fault_model is not None
                or self.round_deadline is not None):
            raise ValueError(
                "fault injection / round deadlines are not defined for "
                "the overlapped scheduler (its staleness-1 pipeline has "
                "no per-node timeline) — use schedule='sync' or 'async'")
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if not self.retry_backoff >= 1.0:
            raise ValueError(f"retry_backoff must be >= 1.0 (deadlines "
                             f"must not shrink), got {self.retry_backoff}")
        if not 1 <= self.min_participants <= self.nodes_per_round:
            raise ValueError(
                f"min_participants ({self.min_participants}) must be in "
                f"[1, nodes_per_round={self.nodes_per_round}]")
        if self.server_opt != "none" and agg.combine != "average":
            raise ValueError(
                f"server_opt {self.server_opt!r} smooths the aggregated "
                f"additive delta; {self.aggregation!r} "
                f"(combine={agg.combine!r}) has none — use an 'average' "
                "combine strategy")
        if not 0.0 <= self.server_momentum < 1.0:
            raise ValueError(f"server_momentum must be in [0, 1), got "
                             f"{self.server_momentum}")
        if self.async_commit is not None and not (
                1 <= self.async_commit <= self.nodes_per_round):
            raise ValueError(
                f"async_commit (K={self.async_commit}) must be in "
                f"[1, nodes_per_round={self.nodes_per_round}]")
        if not 0.0 < self.staleness_decay <= 1.0:
            raise ValueError(f"staleness_decay must be in (0, 1], got "
                             f"{self.staleness_decay}")
        if not (1 <= self.nodes_per_round <= self.num_nodes):
            raise ValueError(
                f"need 1 <= nodes_per_round ({self.nodes_per_round}) <= "
                f"num_nodes ({self.num_nodes})")
        if self.interval_length < 1:
            raise ValueError(f"interval_length must be >= 1, got "
                             f"{self.interval_length}")
        if not 0.0 <= self.dropout_rate < 1.0:
            raise ValueError(f"dropout_rate must be in [0, 1), got "
                             f"{self.dropout_rate}")
        if self.node_sizes is not None:
            if len(self.node_sizes) != self.num_nodes:
                raise ValueError(
                    f"node_sizes has {len(self.node_sizes)} entries for "
                    f"num_nodes={self.num_nodes}")
            if any(int(s) < 1 for s in self.node_sizes):
                raise ValueError(f"node_sizes must be positive: "
                                 f"{self.node_sizes}")
        if (self.participation == "full"
                and self.nodes_per_round != self.num_nodes):
            raise ValueError(
                f"'full' participation needs nodes_per_round "
                f"({self.nodes_per_round}) == num_nodes ({self.num_nodes})")
        if self.substrate == "quantum":
            if not self.widths or len(self.widths) < 2:
                raise ValueError("quantum spec needs widths with >= 2 "
                                 f"layers, got {self.widths!r}")
            if any(int(w) < 1 for w in self.widths):
                raise ValueError(f"widths must be positive: {self.widths}")
            if self.engine not in ("local", "local_opb", "dense"):
                raise ValueError(f"unknown engine {self.engine!r}")
            if self.impl not in ("xla", "pallas"):
                raise ValueError(f"unknown impl {self.impl!r}")
            if self.fanout not in ("auto", "vmap", "shard_map"):
                raise ValueError(f"unknown fanout {self.fanout!r}")
            if self.minibatch is not None and self.minibatch < 1:
                raise ValueError(f"minibatch must be positive, got "
                                 f"{self.minibatch}")
            # approximate-rank knobs: validate through the engine's own
            # resolver, and only the certified local engine may use them
            from repro_torch.core.quantum import linalg as ql
            approx = ql.resolve_approx(self.rank_tol, self.rank_cap,
                                       self.ensemble_dtype)
            if approx is not None and self.engine != "local":
                raise ValueError(
                    "rank_tol/rank_cap/ensemble_dtype select the "
                    "certified approximate engine — engine='local' only, "
                    f"got engine={self.engine!r}")
        else:
            # the two-level tree regroups the quantum combiners; the
            # classical delta stack has no pod tier (yet)
            if self.topology != "flat":
                raise ValueError(
                    "topology='two_level' (hierarchical aggregation) is "
                    "quantum-only; the classical substrate aggregates flat")
            # the classical substrate aggregates additive deltas — the
            # multiplicative Eq. 6 form does not exist for it
            if agg.combine != "average":
                raise ValueError(
                    f"classical substrate needs an additive aggregation; "
                    f"{self.aggregation!r} (combine={agg.combine!r}) is "
                    "quantum-only")
            if self.upload_noise > 0.0:
                raise ValueError(
                    "upload_noise (Hermitian GUE channel) is quantum-only"
                    " — real deltas have no GUE perturbation; use "
                    "quantize_bits for a classical channel")
            if (self.rank_tol != 0.0 or self.rank_cap is not None
                    or self.ensemble_dtype is not None):
                raise ValueError("rank_tol/rank_cap/ensemble_dtype (the "
                                 "certified approximate-rank engine) are "
                                 "quantum-only")

    # -- constructors ---------------------------------------------------
    @classmethod
    def quantum(cls, widths: Tuple[int, ...], *, aggregation: str = "product",
                **kw) -> "FedSpec":
        """A quantum federation spec (paper defaults: Eq. 6 product)."""
        return cls(substrate="quantum", widths=tuple(int(w) for w in widths),
                   aggregation=aggregation, **kw)

    @classmethod
    def classical(cls, arch: str, **kw) -> "FedSpec":
        """A classical (LM / pytree-model) federation spec."""
        return cls(substrate="classical", arch=arch, **kw)

    # -- grouping -------------------------------------------------------
    def fingerprint(self) -> str:
        """Stable hex digest over the group-relevant fields — the key
        the serving layer batches sessions by, equal to the reference's
        for the same spec. Two specs with equal fingerprints describe
        the same federation round (same structure, shapes and registry
        strategies) and may
        differ only in traced hyperparameters (eta / eps /
        server_momentum) and data content (seeds, noise, iid-ness, test
        size) — exactly what ``server_round_stacked`` lets tenants of
        one group vary. Survives the JSON round-trip: ``from_json(
        to_json()).fingerprint() == fingerprint()``."""
        d = self.to_json_dict()
        d.pop("version")
        for f in _NON_GROUPING_FIELDS:
            d.pop(f)
        blob = json.dumps(d, sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    # -- JSON round-trip ------------------------------------------------
    def to_json_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for f in _TUPLE_FIELDS:
            if d[f] is not None:
                d[f] = list(d[f])
        d["version"] = SPEC_VERSION
        return d

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_json_dict(), indent=indent,
                          sort_keys=True)

    @classmethod
    def from_json(cls, blob) -> "FedSpec":
        """Rebuild a spec from ``to_json`` output (str or dict)."""
        d = dict(json.loads(blob) if isinstance(blob, str) else blob)
        version = d.pop("version", SPEC_VERSION)
        if version > SPEC_VERSION:
            raise ValueError(f"spec version {version} is newer than this "
                             f"code ({SPEC_VERSION})")
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown FedSpec fields: {sorted(unknown)}")
        for f in _TUPLE_FIELDS:
            if d.get(f) is not None:
                d[f] = tuple(int(x) for x in d[f])
        return cls(**d)

    # -- lossless legacy-config converters ------------------------------
    def to_quantum_config(self):
        """The legacy ``QuantumFedConfig`` this spec denotes."""
        from repro_torch.core.quantum.federated import QuantumFedConfig
        if self.substrate != "quantum":
            raise ValueError("not a quantum spec")
        return QuantumFedConfig(
            widths=self.widths, num_nodes=self.num_nodes,
            nodes_per_round=self.nodes_per_round,
            interval_length=self.interval_length, eta=self.eta,
            eps=self.eps, minibatch=self.minibatch,
            aggregation=self.aggregation, upload_noise=self.upload_noise,
            engine=self.engine, impl=self.impl,
            participation=self.participation,
            dropout_rate=self.dropout_rate, fanout=self.fanout,
            quantize_bits=self.quantize_bits, rank_tol=self.rank_tol,
            rank_cap=self.rank_cap, ensemble_dtype=self.ensemble_dtype,
            participation_method=self.participation_method,
            topology=self.topology, pods=self.pods,
            pod_assignment=self.pod_assignment, defense=self.defense,
            trim_frac=self.trim_frac, clip_norm=self.clip_norm,
            screen_tol=self.screen_tol)

    @classmethod
    def from_quantum_config(cls, cfg, **data_recipe) -> "FedSpec":
        """Lossless lift of a legacy ``QuantumFedConfig``; data-recipe
        fields (n_per_node, data_seed, ...) ride along as kwargs."""
        return cls.quantum(
            widths=cfg.widths, num_nodes=cfg.num_nodes,
            nodes_per_round=cfg.nodes_per_round,
            interval_length=cfg.interval_length, eta=cfg.eta, eps=cfg.eps,
            minibatch=cfg.minibatch, aggregation=cfg.aggregation,
            upload_noise=cfg.upload_noise, engine=cfg.engine,
            impl=cfg.impl, participation=cfg.participation,
            dropout_rate=cfg.dropout_rate, fanout=cfg.fanout,
            quantize_bits=cfg.quantize_bits, rank_tol=cfg.rank_tol,
            rank_cap=cfg.rank_cap, ensemble_dtype=cfg.ensemble_dtype,
            participation_method=cfg.participation_method,
            topology=cfg.topology, pods=cfg.pods,
            pod_assignment=cfg.pod_assignment, defense=cfg.defense,
            trim_frac=cfg.trim_frac, clip_norm=cfg.clip_norm,
            screen_tol=cfg.screen_tol, **data_recipe)

    def to_classical_config(self) -> FederatedConfig:
        """The legacy ``FederatedConfig`` this spec denotes."""
        if self.substrate != "classical":
            raise ValueError("not a classical spec")
        if self.quantize_bits is not None:
            raise ValueError(
                "legacy FederatedConfig cannot express the quantization "
                "channel — drive this spec through FederationSession")
        return FederatedConfig(
            num_nodes=self.num_nodes, nodes_per_round=self.nodes_per_round,
            interval_length=self.interval_length,
            aggregation=self.aggregation, participation=self.participation,
            dropout_rate=self.dropout_rate, outer_lr=self.outer_lr,
            delta_dtype=self.delta_dtype)

    @classmethod
    def from_classical_config(cls, cfg: FederatedConfig, arch: str,
                              **extra) -> "FedSpec":
        """Lossless lift of a legacy ``FederatedConfig`` (which never
        carried the model arch — pass it explicitly)."""
        return cls.classical(
            arch=arch, num_nodes=cfg.num_nodes,
            nodes_per_round=cfg.nodes_per_round,
            interval_length=cfg.interval_length,
            aggregation=cfg.aggregation, participation=cfg.participation,
            dropout_rate=cfg.dropout_rate, outer_lr=cfg.outer_lr,
            delta_dtype=cfg.delta_dtype, **extra)
