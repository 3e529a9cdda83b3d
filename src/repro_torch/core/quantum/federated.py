"""QuantumFed: QuanFedNode (Alg. 1) + QuanFedPS (Alg. 2), the port of
``repro.core.quantum.federated`` on its flat, single-device path.

One round is four phases: ``select_phase`` (participation sampling and
the Alg. 2 weights), ``local_phase`` (the QuanFedNode pass of every
selected node), ``transmit_phase`` (channel model and wire cast) and
``aggregate_phase`` (the Eq. 6 product or Eq. 8 average combine).
``server_round`` composes them. The nodes of a round run as one batch
on an explicit leading node axis, where the reference ``vmap``s.

When the transmit phase is an exact identity and the combine is the
product, ``aggregate_product`` reuses the node pass's eigh factors at the
upload scale (e^{i eps (wK)} = V e^{i eps w lam} V^H), so each K is
factored once per round.

``cfg.engine`` picks the node pass's simulation path (``qnn.ENGINES``);
with the approximate-rank knobs set, ``server_round_certified`` also
returns the round's error certificate, the per-node bounds weighted by
the Alg. 2 weights.

The port's randomness comes from a ``torch.Generator``; it does not
replay the reference's ``jax.random`` keys.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.fed import channel as fchannel
from repro_torch.core.fed import participation, strategies
from repro_torch.core.quantum import linalg as ql
from repro_torch.core.quantum import qnn
from repro_torch.core.quantum.data import QuantumDataset


class QuantumFedConfig(NamedTuple):
    """The reference's config, field for field, so that one config means
    the same in both packages. Values whose paths are not in the port
    yet are refused by ``check_supported``."""
    widths: Tuple[int, ...]
    num_nodes: int = 100          # N
    nodes_per_round: int = 10     # N_p
    interval_length: int = 1      # I_l
    eta: float = 1.0
    eps: float = 0.1
    minibatch: Optional[int] = None   # None => GD; int => SGD mini-batch
    aggregation: str = "product"      # strategy registry (fed.strategies)
    upload_noise: float = 0.0
    engine: str = "local"
    impl: str = "xla"                 # "xla" torch | "pallas" CUDA kernels
    participation: str = "uniform"
    participation_method: str = "auto"
    dropout_rate: float = 0.0
    fanout: str = "auto"
    topology: str = "flat"
    pods: Optional[int] = None
    pod_assignment: str = "block"
    quantize_bits: Optional[int] = None
    rank_tol: float = 0.0
    rank_cap: Optional[int] = None
    ensemble_dtype: Optional[str] = None
    defense: Optional[str] = None
    trim_frac: float = 0.2
    clip_norm: float = 1.0
    screen_tol: float = 0.05


# the reference's server optimisers (``repro.core.fed.server_opt``); the
# port has "none" only
SERVER_OPTS = ("none", "momentum", "nesterov")


def check_supported(cfg: QuantumFedConfig) -> QuantumFedConfig:
    """Fail loudly on config values whose paths the port does not have
    (NotImplementedError) and on values no path accepts (ValueError)."""
    if cfg.engine not in qnn.ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}; use one of "
                         f"{qnn.ENGINES}")
    if (ql.resolve_approx(cfg.rank_tol, cfg.rank_cap, cfg.ensemble_dtype)
            is not None and cfg.engine != "local"):
        raise ValueError(
            "approximate rank (rank_tol/rank_cap/ensemble_dtype) is "
            f"engine='local' only; engine={cfg.engine!r} is an exact "
            "oracle/baseline")
    missing = []
    if cfg.topology != "flat":
        missing.append(f"topology={cfg.topology!r}")
    if cfg.fanout not in ("auto", "vmap"):
        missing.append(f"fanout={cfg.fanout!r}")
    if cfg.participation_method not in ("auto", "dense"):
        missing.append(f"participation_method={cfg.participation_method!r}")
    if cfg.defense is not None:
        missing.append(f"defense={cfg.defense!r}")
    if missing:
        raise NotImplementedError("not in the port yet: " + ", ".join(missing))
    qnn._check_impl(cfg.impl)
    strategies.get_aggregation(cfg.aggregation)
    participation.validate(cfg.participation)
    fchannel.resolve_channel(cfg.upload_noise, cfg.quantize_bits)
    return cfg


def _minibatch(gen: torch.Generator, phi_in, phi_out, mask, size: int):
    """Per-node SGD draw of ``size`` pairs without replacement (valid
    pairs only when a mask is given)."""
    p, n_per = phi_in.shape[:2]
    rows = []
    for node in range(p):
        if mask is None:
            idx = torch.randperm(n_per, generator=gen, device=gen.device)
        else:
            prob = mask[node].to(gen.device, torch.float64)
            idx = torch.multinomial(prob, size, replacement=False,
                                    generator=gen)
        rows.append(idx[:size])
    idx = torch.stack(rows).to(phi_in.device)
    take = torch.arange(p, device=phi_in.device)[:, None]
    b_w = None if mask is None else mask[take, idx]
    return phi_in[take, idx], phi_out[take, idx], b_w


def node_update(params: qnn.Params, phi_in: torch.Tensor,
                phi_out: torch.Tensor, gen: torch.Generator, eta, eps,
                cfg: QuantumFedConfig, mask: Optional[torch.Tensor] = None,
                return_factors: bool = False, with_bound: bool = False):
    """QuanFedNode: I_l temporary-update steps on each node's local data,
    through ``cfg.engine`` (and the approximate-rank knobs).

    params: the global layers (m, d, d), shared by every node at the
    start of the round. phi_in/phi_out: (P, n_per, d) for P nodes;
    mask: optional (P, n_per) validity mask of padded nodes.

    Returns the per-step update matrices per layer, stacked
    (P, I_l, m, d, d); with ``return_factors`` also their eigh factors
    (lam (P, I_l, m, d), v (P, I_l, m, d, d)), the ones the temporary
    updates were formed from; with ``with_bound`` last the (P,) float64
    per-node certificates, each summed over the interval's steps (zeros
    for exact configs).
    """
    p_nodes, n_per = phi_in.shape[:2]
    p = [u.expand((p_nodes,) + u.shape) for u in params]
    ks_seq, fac_seq = [], []
    bound = 0.0
    for _ in range(cfg.interval_length):
        if cfg.minibatch is not None and cfg.minibatch < n_per:
            b_in, b_out, b_w = _minibatch(gen, phi_in, phi_out, mask,
                                          cfg.minibatch)
        else:
            b_in, b_out, b_w = phi_in, phi_out, mask
        out = qnn.update_matrices(p, b_in, b_out, cfg.widths, eta,
                                  engine=cfg.engine, impl=cfg.impl,
                                  weights=b_w, rank_tol=cfg.rank_tol,
                                  rank_cap=cfg.rank_cap,
                                  ensemble_dtype=cfg.ensemble_dtype,
                                  with_bound=with_bound)
        if with_bound:
            ks, step_bound = out
            bound = bound + step_bound
        else:
            ks = out
        factors = qnn.eigh_updates(ks)
        p = qnn.apply_updates_eigh(p, factors, eps, impl=cfg.impl)
        ks_seq.append(ks)
        fac_seq.append(factors)
    ks_all = [torch.stack([ks[l] for ks in ks_seq], 1)
              for l in range(len(params))]
    out = [ks_all]
    if return_factors:
        out.append([(torch.stack([f[l][0] for f in fac_seq], 1),
                     torch.stack([f[l][1] for f in fac_seq], 1))
                    for l in range(len(params))])
    if with_bound:
        out.append(bound)
    return out[0] if len(out) == 1 else tuple(out)


def _chain(us: torch.Tensor, upd: torch.Tensor, impl: str) -> torch.Tensor:
    """acc <- upd[T-1] @ ... @ upd[0] @ us, one product per step
    (upd: (T, m, d, d))."""
    for u in upd:
        us = qnn.bmm(u, us, impl=impl)
    return us


def aggregate_product(params: qnn.Params, ks_all: List[torch.Tensor],
                      weights: torch.Tensor, eps, *, impl: str = "xla",
                      factors=None) -> qnn.Params:
    """Eq. 6: U^{l,j} = prod_{k=I_l}^{1} prod_n e^{i eps w_n K_{n,k}},
    then U_{t+1} = U^{l,j} U_t^{l,j}. factors: optional per-layer eigh
    factors of the unscaled K's from the node pass."""
    new_params = []
    for li, (us, ks) in enumerate(zip(params, ks_all)):
        # ks: (N_p, I_l, m, d, d); the float32 weights are cast here only
        if factors is None:
            w = weights[:, None, None, None, None].to(ks.dtype)
            upd = ql.expm_herm(ks * w, eps)
        else:
            lam, v = factors[li]
            wl = weights[:, None, None, None].to(lam.dtype)
            upd = ql.expm_eigh(lam * wl, v, eps)
        # interval step k outermost (k = 1 first), node n innermost
        seq = upd.transpose(0, 1).reshape((-1,) + upd.shape[2:])
        new_params.append(_chain(us, seq, impl))
    return new_params


def aggregate_average(params: qnn.Params, ks_all: List[torch.Tensor],
                      weights: torch.Tensor, eps, *, impl: str = "xla"
                      ) -> qnn.Params:
    """Eq. 8: K_k = sum_n w_n K_{n,k};  U = prod_{k=I_l}^{1} e^{i eps K_k}."""
    new_params = []
    for us, ks in zip(params, ks_all):
        k_bar = torch.einsum("n,nk...->k...", weights.to(ks.dtype), ks)
        new_params.append(_chain(us, ql.expm_herm(k_bar, eps), impl))
    return new_params


def select_phase(dataset: QuantumDataset, gen: torch.Generator,
                 cfg: QuantumFedConfig):
    """Phase 1: ``(sel, pmask, weights)`` for one round; the weights are
    the float32 data volumes N_n / N_t of the selected nodes."""
    check_supported(cfg)
    dev = dataset.phi_in.device
    counts = dataset.node_counts()
    sel, pmask = participation.sample_nodes(
        gen, cfg.num_nodes, cfg.nodes_per_round,
        schedule=cfg.participation, device=dev)
    weights = participation.round_weights(cfg.participation, counts[sel],
                                          pmask)
    return sel, pmask, weights


def local_phase(params: qnn.Params, dataset: QuantumDataset,
                sel: torch.Tensor, gen: torch.Generator,
                cfg: QuantumFedConfig, with_factors: bool = False,
                with_bound: bool = False):
    """Phase 2: the QuanFedNode pass of every selected node; per layer
    (N_p, I_l, m, d, d), plus the eigh factors with ``with_factors`` and
    the (N_p,) per-node certificates with ``with_bound``."""
    check_supported(cfg)
    sel = sel.to(dataset.phi_in.device)
    vmask = dataset.valid_mask()
    return node_update(params, dataset.phi_in[sel], dataset.phi_out[sel],
                       gen, cfg.eta, cfg.eps, cfg,
                       None if vmask is None else vmask[sel],
                       return_factors=with_factors, with_bound=with_bound)


def _factors_survive_wire(cfg: QuantumFedConfig) -> bool:
    """True when the node pass's eigh factors are still valid at the
    aggregate phase: product combine over an exact-identity wire."""
    agg = strategies.get_aggregation(cfg.aggregation)
    return (agg.combine == "product" and agg.wire_dtype is None
            and cfg.upload_noise == 0.0 and cfg.quantize_bits is None
            and cfg.defense is None)


def transmit_phase(ks_all: List[torch.Tensor], gen: torch.Generator,
                   cfg: QuantumFedConfig) -> List[torch.Tensor]:
    """Phase 3: channel model, then the strategy's wire cast."""
    ch = fchannel.resolve_channel(cfg.upload_noise, cfg.quantize_bits)
    agg = strategies.get_aggregation(cfg.aggregation)
    return strategies.wire_cast(ch(gen, ks_all), agg)


def aggregate_phase(params: qnn.Params, ks_all: List[torch.Tensor],
                    weights: torch.Tensor, cfg: QuantumFedConfig,
                    factors=None) -> qnn.Params:
    """Phase 4: the strategy's combine into the global model."""
    check_supported(cfg)
    agg = strategies.get_aggregation(cfg.aggregation)
    if agg.combine == "product":
        return aggregate_product(params, ks_all, weights, cfg.eps,
                                 impl=cfg.impl, factors=factors)
    return aggregate_average(params, ks_all, weights, cfg.eps,
                             impl=cfg.impl)


def server_round(params: qnn.Params, dataset: QuantumDataset,
                 gen: torch.Generator, cfg: QuantumFedConfig) -> qnn.Params:
    """One QuanFedPS iteration: select -> local -> transmit -> aggregate."""
    sel, _, weights = select_phase(dataset, gen, cfg)
    reuse = _factors_survive_wire(cfg)
    out = local_phase(params, dataset, sel, gen, cfg, with_factors=reuse)
    ks_all, factors = out if reuse else (out, None)
    ks_all = transmit_phase(ks_all, gen, cfg)
    return aggregate_phase(params, ks_all, weights, cfg, factors=factors)


def server_round_certified(params: qnn.Params, dataset: QuantumDataset,
                           gen: torch.Generator, cfg: QuantumFedConfig,
                           server_opt: str = "none"):
    """``server_round`` that also returns the round's approximation-error
    certificate: ``(new_params, None, err_bound)``, the None standing for
    the reference's server-optimiser state. err_bound is a float64 scalar
    bounding the total max-abs deviation of the round's update matrices
    from the exact engine's, sum_n w_n bound_n over the selected nodes
    (per-node bounds of ``qnn.update_matrices(with_bound=True)``, Alg. 2
    weights); exactly 0.0 with the approximate-rank knobs off, where the
    new params are those of ``server_round`` bit for bit. The port has
    ``server_opt="none"`` only."""
    if server_opt not in SERVER_OPTS:
        raise ValueError(f"unknown server_opt {server_opt!r}; registered: "
                         f"{list(SERVER_OPTS)}")
    if server_opt != "none":
        raise NotImplementedError(
            f"not in the port yet: server_opt={server_opt!r}")
    sel, _, weights = select_phase(dataset, gen, cfg)
    reuse = _factors_survive_wire(cfg)
    out = local_phase(params, dataset, sel, gen, cfg, with_factors=reuse,
                      with_bound=True)
    (ks_all, factors, bounds) = out if reuse else (out[0], None, out[1])
    ks_all = transmit_phase(ks_all, gen, cfg)
    new_params = aggregate_phase(params, ks_all, weights, cfg,
                                 factors=factors)
    err_bound = torch.sum(weights.to(bounds.device, torch.float64) * bounds)
    return new_params, None, err_bound


def evaluate(params: qnn.Params, phi_in: torch.Tensor,
             phi_out: torch.Tensor, widths: Tuple[int, ...],
             impl: str = "xla", weights: Optional[torch.Tensor] = None
             ) -> Dict[str, torch.Tensor]:
    """Mean fidelity / MSE (both through ``impl``); ``weights`` masks
    out padded invalid pairs."""
    rho_out = qnn.outputs(params, phi_in, widths, impl=impl)
    fid = qnn.batched_fidelity(phi_out, rho_out, impl=impl)
    mse = qnn.batched_mse(phi_out, rho_out, impl=impl)
    if weights is None:
        return {"fidelity": torch.mean(fid), "mse": torch.mean(mse)}
    w = weights.to(fid.dtype)
    denom = torch.clamp(torch.sum(w), min=1e-12)
    return {"fidelity": torch.sum(w * fid) / denom,
            "mse": torch.sum(w * mse) / denom}
