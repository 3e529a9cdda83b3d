"""QuantumFed: QuanFedNode (Alg. 1) + QuanFedPS (Alg. 2), the port of
``repro.core.quantum.federated``.

One round is four phases: ``select_phase`` (participation sampling and
the Alg. 2 weights), ``local_phase`` (the QuanFedNode pass of every
selected node), ``transmit_phase`` (channel model and wire cast) and
``aggregate_phase`` (the Eq. 6 product or Eq. 8 average combine, an
optional Byzantine-robust defense, optional server momentum on the
averaged generators). ``server_round`` / ``server_round_opt`` /
``server_round_certified`` compose them. The nodes of a round run as one
batch on an explicit leading node axis, where the reference ``vmap``s.

``cfg.fanout`` spreads the node pass over ranks, as the reference's
``shard_map`` over its mesh: under ``with mesh:`` (a DeviceMesh whose
'fed_node' rule axis, 'pod', divides N_p), "shard_map" (or "auto" with
more than one rank on that axis) has each rank run the node pass of its
contiguous block of the round's nodes. The selection and every per-node
draw are made before the split, on every rank alike, and the uploads
are gathered in node order over the 'pod' group
(``sharding.collectives``), so every rank runs the same Eq. 6 chain (or
Eq. 8 sum) on all of them; a two-level tree's pod tier is spread the
same way (``hierarchy``). On one rank the round is the batched round
bit for bit. Stacked rounds always run batched.

``cfg.topology="two_level"`` routes either combine through the pod tree
of ``repro_torch.core.fed.cohort.hierarchy`` (an exact reassociation,
so its rounding differs from the flat chain's only in order).

Every phase body runs on a leading session axis S: a solo round is the
stack of one. ``server_round_stacked`` drives S independent federations
of one structural config (their own params, data, draws, eta, eps and
momentum) as one round: the node pass runs over S * N_p nodes and every
combine chain over (S * m, d, d), so a stacked round launches as many
kernels as a solo one.

When the transmit phase is an exact identity and the combine is the
undefended product, ``aggregate_product`` reuses the node pass's eigh
factors at the upload scale (e^{i eps (wK)} = V e^{i eps w lam} V^H), so
each K is factored once per round.

``cfg.engine`` picks the node pass's simulation path (``qnn.ENGINES``);
with the approximate-rank knobs set, ``server_round_certified`` also
returns the round's error certificate, the per-node bounds weighted by
the Alg. 2 weights.

The port's randomness comes from ``torch.Generator``s; it does not
replay the reference's ``jax.random`` keys. Each phase takes its draws
from the generator it is given, in a fixed order (selection, the
interval's minibatches, the channel), so the parity tests inject the
reference's selection and uploads instead.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.fed import channel as fchannel
from repro_torch.core.fed import participation, strategies
from repro_torch.core.fed import server_opt as fserver_opt
from repro_torch.core.fed.cohort import hierarchy as fhierarchy
from repro_torch.core.fed.cohort import topology as ftopology
from repro_torch.core.quantum import linalg as ql
from repro_torch.core.quantum import qnn
from repro_torch.core.quantum.data import QuantumDataset
from repro_torch.sharding import collectives, rules

Gens = Union[torch.Generator, Sequence[torch.Generator]]


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
    upload_noise: float = 0.0         # channel registry: "hermitian"
    engine: str = "local"
    impl: str = "xla"                 # "xla" torch | "pallas" CUDA kernels
    participation: str = "uniform"    # schedule registry
    participation_method: str = "auto"    # uniform-draw cost policy
    dropout_rate: float = 0.0         # straggler rate for "dropout"
    fanout: str = "auto"
    topology: str = "flat"
    pods: Optional[int] = None
    pod_assignment: str = "block"
    quantize_bits: Optional[int] = None  # channel registry: "quantize"
    rank_tol: float = 0.0
    rank_cap: Optional[int] = None
    ensemble_dtype: Optional[str] = None
    defense: Optional[str] = None     # strategies.DEFENSES
    trim_frac: float = 0.2            # trimmed_mean: trim fraction/side
    clip_norm: float = 1.0            # clip: per-matrix Frobenius bound
    screen_tol: float = 0.05          # screen: allowed fidelity drop


SERVER_OPTS = fserver_opt.SERVER_OPTS


def _topology_of(cfg: QuantumFedConfig) -> Optional[ftopology.Topology]:
    """The aggregation-tree ``Topology`` a cfg names, None for flat.
    Validates first (pods dividing the cohort, block order for the
    product combine), with the reference's messages."""
    agg = strategies.get_aggregation(cfg.aggregation)
    ftopology.validate_topology(
        cfg.topology, cfg.pods, cfg.pod_assignment,
        nodes_per_round=cfg.nodes_per_round, combine=agg.combine)
    return ftopology.resolve_topology(cfg.topology, cfg.pods,
                                      cfg.pod_assignment)


def check_supported(cfg: QuantumFedConfig) -> QuantumFedConfig:
    """Fail loudly (ValueError) on config values no path accepts."""
    if cfg.engine not in qnn.ENGINES:
        raise ValueError(f"unknown engine {cfg.engine!r}; use one of "
                         f"{qnn.ENGINES}")
    if (ql.resolve_approx(cfg.rank_tol, cfg.rank_cap, cfg.ensemble_dtype)
            is not None and cfg.engine != "local"):
        raise ValueError(
            "approximate rank (rank_tol/rank_cap/ensemble_dtype) is "
            f"engine='local' only; engine={cfg.engine!r} is an exact "
            "oracle/baseline")
    agg = strategies.get_aggregation(cfg.aggregation)
    strategies.validate_defense(cfg.defense, agg.combine)
    if cfg.defense in ("trimmed_mean", "median") and cfg.topology != "flat":
        raise ValueError(
            f"defense {cfg.defense!r} needs every upload at the server "
            "(order statistics do not decompose over pod partial sums) — "
            "topology='flat' only")
    if _topology_of(cfg) is not None:
        strategies.partial_kind(agg)    # fail loudly for tree-less combines
    if cfg.fanout not in ("auto", "vmap", "shard_map"):
        raise ValueError(f"unknown fanout {cfg.fanout!r}; use "
                         "'auto' | 'vmap' | 'shard_map'")
    qnn._check_impl(cfg.impl)
    participation.validate(cfg.participation)
    participation.validate_method(cfg.participation_method)
    fchannel.resolve_channel(cfg.upload_noise, cfg.quantize_bits)
    return cfg


def _approx_on(cfg: QuantumFedConfig) -> bool:
    return ql.resolve_approx(cfg.rank_tol, cfg.rank_cap,
                             cfg.ensemble_dtype) is not None


def _gen_list(gen: Gens) -> List[torch.Generator]:
    return [gen] if isinstance(gen, torch.Generator) else list(gen)


def _lead(x, ndim: int):
    """A scalar as it is, or a tensor with one value per entry of the
    leading axis, shaped to broadcast against ``ndim``-dim arrays."""
    if not torch.is_tensor(x):
        return x
    return x.reshape((-1,) + (1,) * (ndim - 1))


def _per_node(x, p: int):
    """A per-session scalar or (S,) tensor as one value per node of the
    S * p node batch (each session's value repeated p times)."""
    return x.repeat_interleave(p) if torch.is_tensor(x) else x


def _draw(gens: List[torch.Generator], phi_in, mask, size: int):
    """Per-node SGD draw of ``size`` pair indices without replacement
    (valid pairs only when a mask is given): (P, size). The nodes split
    into len(gens) equal blocks, block b drawing from gens[b] in node
    order."""
    p, n_per = phi_in.shape[:2]
    per = p // len(gens)
    rows = []
    for node in range(p):
        gen = gens[node // per]
        if mask is None:
            idx = torch.randperm(n_per, generator=gen, device=gen.device)
        else:
            prob = mask[node].to(gen.device, torch.float64)
            idx = torch.multinomial(prob, size, replacement=False,
                                    generator=gen)
        rows.append(idx[:size].to(phi_in.device))
    return torch.stack(rows)


def _draws(gens: List[torch.Generator], phi_in, mask,
           cfg: QuantumFedConfig) -> Optional[List[torch.Tensor]]:
    """Every interval step's minibatch draw for every node, in step
    order; None under GD (or a minibatch no smaller than the data)."""
    if cfg.minibatch is None or cfg.minibatch >= phi_in.shape[1]:
        return None
    return [_draw(gens, phi_in, mask, cfg.minibatch)
            for _ in range(cfg.interval_length)]


def _minibatch(phi_in, phi_out, mask, idx):
    take = torch.arange(idx.shape[0], device=phi_in.device)[:, None]
    b_w = None if mask is None else mask[take, idx]
    return phi_in[take, idx], phi_out[take, idx], b_w


def node_update(params: qnn.Params, phi_in: torch.Tensor,
                phi_out: torch.Tensor, gen: Gens, eta, eps,
                cfg: QuantumFedConfig, mask: Optional[torch.Tensor] = None,
                return_factors: bool = False, with_bound: bool = False,
                draws: Optional[List[torch.Tensor]] = None):
    """QuanFedNode: I_l temporary-update steps on each node's local data,
    through ``cfg.engine`` (and the approximate-rank knobs).

    params: the global layers (m, d, d) shared by every node, or
    (P, m, d, d) one per node. phi_in/phi_out: (P, n_per, d) for P
    nodes; mask: optional (P, n_per) validity mask of padded nodes.
    eta, eps: scalars, or (P,) tensors of one value per node (K is
    linear in eta: a per-node eta scales the unit-eta K's). gen: one
    generator, or one per equal block of nodes (the minibatch draws,
    every step's made first, in step order); or ``draws``: those
    (P, minibatch) index draws, one a step, made already.

    Returns the per-step update matrices per layer, stacked
    (P, I_l, m, d, d); with ``return_factors`` also their eigh factors
    (lam (P, I_l, m, d), v (P, I_l, m, d, d)), the ones the temporary
    updates were formed from; with ``with_bound`` last the (P,) float64
    per-node certificates, each summed over the interval's steps (zeros
    for exact configs).
    """
    if draws is None:
        draws = _draws(_gen_list(gen), phi_in, mask, cfg)
    p_nodes = phi_in.shape[0]
    p = [u if u.dim() == 4 else u.expand((p_nodes,) + u.shape)
         for u in params]
    eta_scale = eta if torch.is_tensor(eta) else None
    eta_k = 1.0 if eta_scale is not None else eta
    eps_k = _lead(eps, 3)
    ks_seq, fac_seq = [], []
    bound = 0.0
    for step in range(cfg.interval_length):
        if draws is not None:
            b_in, b_out, b_w = _minibatch(phi_in, phi_out, mask, draws[step])
        else:
            b_in, b_out, b_w = phi_in, phi_out, mask
        out = qnn.update_matrices(p, b_in, b_out, cfg.widths, eta_k,
                                  engine=cfg.engine, impl=cfg.impl,
                                  weights=b_w, rank_tol=cfg.rank_tol,
                                  rank_cap=cfg.rank_cap,
                                  ensemble_dtype=cfg.ensemble_dtype,
                                  with_bound=with_bound)
        ks, step_bound = out if with_bound else (out, None)
        if eta_scale is not None:
            ks = [k * _lead(eta_scale, 4).to(k.real.dtype) for k in ks]
            if with_bound:
                step_bound = step_bound * eta_scale.to(torch.float64)
        if with_bound:
            bound = bound + step_bound
        factors = qnn.eigh_updates(ks)
        p = qnn.apply_updates_eigh(p, factors, eps_k, impl=cfg.impl)
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


def _chain(us: torch.Tensor, seq: torch.Tensor, impl: str) -> torch.Tensor:
    """acc <- seq[T-1] @ ... @ seq[0] @ us, one product per step over the
    whole batch (seq: (T, *us.shape))."""
    for u in seq:
        us = qnn.bmm(u, us, impl=impl)
    return us


def _steps_first(upd: torch.Tensor) -> torch.Tensor:
    """(S, T, m, d, d) -> the (T, S, m, d, d) chain sequence, each step
    one dense batch."""
    return upd.transpose(0, 1).contiguous()


# ------------------------------------------------- combines, session axis
# Shapes below: params per layer (S, m, d, d); uploads per layer
# (S, P, I_l, m, d, d); weights (S, P) float32; eps and beta scalars or
# (S,) tensors; momentum per layer (S, I_l, m, d, d) or None.

def _product(params, ks_all, weights, eps, impl, factors=None, topo=None,
             mesh=None):
    """Eq. 6 for every session: U <- prod_{k=I_l}^{1} prod_n
    e^{i eps w_n K_{n,k}} U, one chain over (S * m, d, d); under a
    ``topo`` the same chain reassociated by pod (``hierarchy.tree_chain``,
    its pod tier spread over ``mesh``'s 'pod' axis when it splits)."""
    new_params = []
    for li, (us, ks) in enumerate(zip(params, ks_all)):
        s, p, il = ks.shape[:3]
        if factors is None:
            w = weights[:, :, None, None, None, None].to(ks.dtype)
            upd = ql.expm_herm(ks * w, _lead(eps, 5))
        else:
            lam, v = factors[li]
            wl = weights[:, :, None, None, None].to(lam.dtype)
            upd = ql.expm_eigh(lam * wl, v, _lead(eps, 5))
        if topo is not None:
            new_params.append(fhierarchy.tree_chain(us, upd, topo,
                                                    impl=impl, mesh=mesh))
            continue
        # interval step k outermost (k = 1 first), node n innermost
        seq = upd.permute(2, 1, 0, 3, 4, 5).reshape(
            (il * p, s) + upd.shape[3:])
        new_params.append(_chain(us, seq, impl))
    return new_params


def _probe_fidelity(params: qnn.Params, probe, widths, impl):
    """Mean fidelity of ``params`` on the server's probe batch: layers
    (m, d, d) with probe states (X, d) give a scalar, layers (B, m, d, d)
    with (B, X, d) one mean per entry of B."""
    phi_in, phi_out = probe
    rho = qnn.outputs(params, phi_in, widths, impl=impl)
    return torch.mean(qnn.batched_fidelity(phi_out, rho, impl=impl), dim=-1)


def _screen_uploads(params, ks_all, weights, eps, cfg: QuantumFedConfig,
                    probe):
    """defense="screen", the behavioural defense of the Eq. 6 product.
    Each node's CANDIDATE model (its own update chain e^{i eps K_{n,k}}
    on the global params) is scored on the server's probe batch; uploads
    whose fidelity falls more than ``screen_tol`` below the pre-round
    baseline are quarantined: weight zeroed (mass renormalised over the
    survivors) and generators zeroed so a NaN payload cannot reach the
    eigh. A NaN candidate fidelity compares False and quarantines
    itself. The S * P candidates run as one batch on the node axis.
    probe: (phi_in, phi_out), each (S, X, d). Returns ``(clean, weights,
    keep)``."""
    if probe is None:
        raise ValueError(
            "defense='screen' needs a server probe batch: pass "
            "probe=(phi_in, phi_out), e.g. the held-out test pairs")
    s, p = weights.shape
    base = _probe_fidelity(params, probe, cfg.widths, cfg.impl)     # (S,)
    eps_n = _per_node(eps, p)
    cand = []
    for us, ks in zip(params, ks_all):
        upd = ql.expm_herm(ks.flatten(0, 1), _lead(eps_n, 4))
        cand.append(_chain(us.repeat_interleave(p, 0), _steps_first(upd),
                           cfg.impl))
    cprobe = tuple(x.repeat_interleave(p, 0) for x in probe)
    fids = _probe_fidelity(cand, cprobe, cfg.widths, cfg.impl).reshape(s, p)
    keep = fids >= base[:, None] - cfg.screen_tol          # NaN => False
    w = weights * keep.to(weights.dtype)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    kb = keep.reshape(s, p, 1, 1, 1, 1)
    clean = [torch.where(kb, ks, torch.zeros((), dtype=ks.dtype,
                                             device=ks.device))
             for ks in ks_all]
    return clean, w, keep


def _finite(ks_all) -> torch.Tensor:
    """(S, P) bool: each node's upload is finite in every layer."""
    s, p = ks_all[0].shape[:2]
    return strategies.finite_nodes([k.flatten(0, 1) for k in ks_all]
                                   ).reshape(s, p)


def _clip_uploads(ks_all, weights, clip_norm: float):
    """defense="clip": per-matrix Frobenius norm-clip of every uploaded
    generator; non-finite uploads are zeroed and de-weighted (their mass
    renormalised over the finite nodes). Returns ``(clean, weights)``."""
    s, p = weights.shape
    fin = _finite(ks_all)
    w = weights * fin.to(weights.dtype)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-12)
    fb = fin.reshape(s, p, 1, 1, 1, 1)
    clean = []
    for ks in ks_all:
        f = strategies.clip_factors(ks, clip_norm)      # (..., 1, 1) real
        clean.append(torch.where(fb, ks * f.to(ks.real.dtype),
                                 torch.zeros((), dtype=ks.dtype,
                                             device=ks.device)))
    return clean, w


def _aggregate(params, smom, ks_all, weights, eps, beta,
               cfg: QuantumFedConfig, server_opt: str, factors=None,
               probe=None, mesh=None):
    """The strategy's combine for every session, with ``cfg.defense``
    and, for average combines, server momentum on the averaged
    generators K̄_k. Returns ``(new_params, new_smom)``, new_smom None
    when ``server_opt == "none"``."""
    agg = strategies.get_aggregation(cfg.aggregation)
    strategies.validate_defense(cfg.defense, agg.combine)
    fserver_opt.validate(server_opt)
    topo = _topology_of(cfg)
    if agg.combine == "product":
        if server_opt != "none":
            raise ValueError(
                f"server_opt={server_opt!r} smooths the additive Eq. 8 "
                "delta; the Eq. 6 product has none (aggregation "
                f"{cfg.aggregation!r})")
        if cfg.defense == "screen":
            ks_all, weights, _ = _screen_uploads(params, ks_all, weights,
                                                 eps, cfg, probe)
            factors = None  # factor the SANITIZED K's, not the raw ones
        return _product(params, ks_all, weights, eps, cfg.impl,
                        factors, topo, mesh), None
    if cfg.defense == "clip":
        ks_all, weights = _clip_uploads(ks_all, weights, cfg.clip_norm)
    robust = cfg.defense in ("trimmed_mean", "median")
    # order statistics treat every valid node equally: the data-volume
    # weights only gate validity (a 0-weight or non-finite upload never
    # enters the sort window)
    valid = (weights > 0) & _finite(ks_all) if robust else None
    k_bars = [strategies.robust_combine(ks.transpose(0, 1), valid.T,
                                        cfg.defense, cfg.trim_frac)
              if robust else _weighted_mean(ks, weights, topo, mesh)
              for ks in ks_all]
    return _average(params, smom, k_bars, eps, beta, server_opt, cfg.impl)


def _weighted_mean(ks, weights, topo=None, mesh=None):
    """Eq. 8's K_k = sum_n w_n K_{n,k} per session: (S, I_l, m, d, d);
    the flat einsum, or under a ``topo`` the pod-partial sums merged
    (``hierarchy.tree_mean_generators``)."""
    if topo is not None:
        return fhierarchy.tree_mean_generators(ks, weights, topo, mesh=mesh)
    return torch.einsum("sn,snk...->sk...", weights.to(ks.dtype), ks)


def _average(params, smom, k_bars, eps, beta, server_opt: str, impl: str):
    """U <- prod_{k=I_l}^{1} e^{i eps K_eff,k} U per session, K_eff the
    mean generators k_bars after the server momentum step (k_bars
    themselves for ``server_opt="none"``). Returns ``(new_params,
    new_smom)``."""
    new_params, new_smom = [], []
    for i, (us, k_bar) in enumerate(zip(params, k_bars)):
        m2, eff = fserver_opt.generator_step(
            server_opt, _lead(beta, 5), None if smom is None else smom[i],
            k_bar)
        upd = ql.expm_herm(eff, _lead(eps, 4))    # e^{i eps K_eff}: unitary
        new_params.append(_chain(us, _steps_first(upd), impl))
        new_smom.append(m2)
    return new_params, (None if server_opt == "none" else new_smom)


# ------------------------------------------------ phases, session axis
def _gather_nodes(dataset: QuantumDataset, sel: torch.Tensor):
    """The selected nodes' (S * P, n_per, d) states and validity mask."""
    s = sel.shape[0]
    take = torch.arange(s, device=sel.device)[:, None]
    vmask = dataset.valid_mask()
    return (dataset.phi_in[take, sel].flatten(0, 1),
            dataset.phi_out[take, sel].flatten(0, 1),
            None if vmask is None else vmask[take, sel].flatten(0, 1))


def _select(dataset: QuantumDataset, gens: List[torch.Generator],
            cfg: QuantumFedConfig):
    """Each session's selection from its own generator: (sel, pmask,
    weights), each (S, P), on the dataset's device (made on the host
    and copied once)."""
    dev = dataset.phi_in.device
    counts = dataset.node_counts()                            # (S, N)
    host = counts.cpu() if cfg.participation == "weighted" else None
    sels, masks = [], []
    for s, gen in enumerate(gens):
        sel, mask = participation.sample_nodes(
            gen, cfg.num_nodes, cfg.nodes_per_round, device="cpu",
            schedule=cfg.participation,
            node_sizes=None if host is None else host[s],
            dropout_rate=cfg.dropout_rate, method=cfg.participation_method)
        sels.append(sel)
        masks.append(mask)
    sel, pmask = torch.stack(sels).to(dev), torch.stack(masks).to(dev)
    weights = participation.round_weights(cfg.participation,
                                          torch.gather(counts, 1, sel), pmask)
    return sel, pmask, weights


def _fan_out(params, phi_in, phi_out, mask, gens, eta, eps,
             cfg: QuantumFedConfig, mesh, with_factors: bool,
             with_bound: bool):
    """The node pass of a batch of nodes: in one batch, or with
    ``cfg.fanout == "shard_map"`` each rank of ``mesh``'s 'fed_node' axis
    running its contiguous block of them and the outputs gathered in
    node order over that axis, all in one collective. Every minibatch
    draw is made first, for all the nodes, on every rank alike. Returns
    ``node_update``'s outputs as a tuple."""
    if cfg.fanout != "shard_map":
        out = node_update(params, phi_in, phi_out, gens, eta, eps, cfg, mask,
                          return_factors=with_factors, with_bound=with_bound)
        return out if isinstance(out, tuple) else (out,)
    axis = rules.fed_fanout_axis(mesh) if mesh is not None else None
    if axis is None:
        raise ValueError(
            "fanout='shard_map' needs a mesh carrying the 'fed_node' "
            "rule axis (e.g. 'pod'); use `with mesh:` or fanout='auto' "
            "for the vmap fallback")
    ranks = rules.axis_size(mesh, axis)
    if cfg.nodes_per_round % ranks != 0:
        raise ValueError(
            f"nodes_per_round={cfg.nodes_per_round} must be divisible by "
            f"mesh axis '{axis}' of size {ranks}")
    draws = _draws(gens, phi_in, mask, cfg)
    per = phi_in.shape[0] // ranks
    lo = collectives.axis_rank(mesh, axis) * per
    mine = slice(lo, lo + per)

    def block(x):
        return x[mine] if torch.is_tensor(x) and x.dim() else x
    out = node_update([u[mine] for u in params], phi_in[mine],
                      phi_out[mine], [], block(eta), block(eps), cfg,
                      block(mask), return_factors=with_factors,
                      with_bound=with_bound,
                      draws=None if draws is None else [d[mine]
                                                        for d in draws])
    out = out if isinstance(out, tuple) else (out,)
    # every output of the block in one gather, in node order
    n_l = len(out[0])
    flat = list(out[0])
    if with_factors:
        flat += [x for lam_v in out[1] for x in lam_v]
    if with_bound:
        flat.append(out[-1].to(flat[-1].real.dtype))
    full = collectives.all_gather_rows(flat, mesh, axis)
    res = [full[:n_l]]
    if with_factors:
        res.append(list(zip(full[n_l:3 * n_l:2], full[n_l + 1:3 * n_l:2])))
    if with_bound:
        res.append(full[-1].to(out[-1].dtype))
    return tuple(res)


def _local(params, dataset: QuantumDataset, sel: torch.Tensor,
           gens: Optional[List[torch.Generator]], eta, eps,
           cfg: QuantumFedConfig, with_factors: bool, with_bound: bool,
           mesh=None):
    """The node pass of every session's selected nodes as one batch of
    S * P nodes (spread over ``mesh`` by ``_fan_out``); outputs regrouped
    per session: uploads (S, P, I_l, m, d, d) per layer, factors
    likewise, bounds (S, P)."""
    s, p = sel.shape
    phi_in, phi_out, mask = _gather_nodes(dataset, sel.to(
        dataset.phi_in.device))
    out = _fan_out([u.repeat_interleave(p, 0) for u in params], phi_in,
                   phi_out, mask, gens if gens is not None else [],
                   _per_node(eta, p), _per_node(eps, p), cfg, mesh,
                   with_factors, with_bound)

    def split(x):
        return x.reshape((s, p) + x.shape[1:])
    ks = [split(k) for k in out[0]]
    res = [ks]
    if with_factors:
        res.append([(split(lam), split(v)) for lam, v in out[1]])
    if with_bound:
        res.append(split(out[-1]))
    return res[0] if len(res) == 1 else tuple(res)


def _transmit(ks_all, gens: Optional[List[torch.Generator]],
              cfg: QuantumFedConfig):
    """Each session's uploads through the channel (its own generator),
    then the strategy's wire cast."""
    ch = fchannel.resolve_channel(cfg.upload_noise, cfg.quantize_bits)
    agg = strategies.get_aggregation(cfg.aggregation)
    if not isinstance(ch, fchannel.IdentityChannel):
        ks_all = [torch.stack(parts) for parts in zip(*(
            ch(gen, [k[i] for k in ks_all]) for i, gen in enumerate(gens)))]
    return strategies.wire_cast(ks_all, agg)


def _factors_survive_wire(cfg: QuantumFedConfig) -> bool:
    """True when the node pass's eigh factors are still valid at the
    aggregate phase: product combine over an exact-identity wire, no
    defense (the screened product re-weights quarantined uploads)."""
    agg = strategies.get_aggregation(cfg.aggregation)
    return (agg.combine == "product" and agg.wire_dtype is None
            and cfg.upload_noise == 0.0 and cfg.quantize_bits is None
            and cfg.defense is None)


def _round(params, smom, dataset: QuantumDataset,
           gens: Optional[List[torch.Generator]],
           sel: Optional[torch.Tensor], eta, eps, beta,
           cfg: QuantumFedConfig, server_opt: str, probe, certify: bool,
           mesh=None):
    """select -> local -> transmit -> aggregate for S sessions. Returns
    ``(new_params, new_smom, err_bound (S,) float64)``."""
    if sel is None:
        sel, _, weights = _select(dataset, gens, cfg)
    else:
        sel = sel.to(dataset.phi_in.device)
        weights = participation.round_weights(
            cfg.participation, torch.gather(dataset.node_counts(), 1, sel),
            torch.ones(sel.shape, dtype=torch.float32, device=sel.device))
    reuse = _factors_survive_wire(cfg)
    out = _local(params, dataset, sel, gens, eta, eps, cfg,
                 with_factors=reuse, with_bound=certify, mesh=mesh)
    out = out if isinstance(out, tuple) else (out,)
    ks_all = out[0]
    factors = out[1] if reuse else None
    ks_all = _transmit(ks_all, gens, cfg)
    new_params, new_smom = _aggregate(params, smom, ks_all, weights, eps,
                                      beta, cfg, server_opt, factors, probe,
                                      mesh)
    if certify:
        err = torch.sum(weights.to(torch.float64) * out[-1].to(
            weights.device), dim=-1)
    else:
        err = torch.zeros(sel.shape[:1], dtype=torch.float64,
                          device=sel.device)
    return new_params, new_smom, err


# ----------------------------------------------------- solo entry points
def _resolve_fanout(cfg: QuantumFedConfig) -> str:
    """The fan-out a solo round runs: "vmap" (one batch) or "shard_map"
    (spread over the ambient mesh's 'fed_node' axis), read from the
    mesh entered with ``with mesh:``."""
    if cfg.fanout == "vmap":
        return "vmap"
    mesh = rules.current_mesh()
    axis = rules.fed_fanout_axis(mesh) if mesh is not None else None
    ok = (axis is not None
          and cfg.nodes_per_round % rules.axis_size(mesh, axis) == 0)
    if cfg.fanout == "shard_map":
        if not ok:
            raise ValueError(
                "fanout='shard_map' needs an active `with mesh:` whose "
                "'fed_node' rule axis divides nodes_per_round")
        return "shard_map"
    if cfg.fanout != "auto":
        raise ValueError(f"unknown fanout {cfg.fanout!r}; use "
                         "'auto' | 'vmap' | 'shard_map'")
    # auto: shard only when the mesh actually has >1 pod to spread over
    return "shard_map" if ok and rules.axis_size(mesh, axis) > 1 else "vmap"


def _round_statics(cfg: QuantumFedConfig):
    """(cfg with its fan-out resolved, the mesh it spreads over or
    None)."""
    fanout = _resolve_fanout(cfg)
    mesh = rules.current_mesh() if fanout == "shard_map" else None
    return cfg._replace(fanout=fanout), mesh


def _one(xs):
    return None if xs is None else [x[None] for x in xs]


def _unone(xs):
    return None if xs is None else [x[0] for x in xs]


def _one_dataset(ds: QuantumDataset) -> QuantumDataset:
    return QuantumDataset(ds.phi_in[None], ds.phi_out[None],
                          None if ds.n_per is None else ds.n_per[None])


def _one_probe(probe):
    return None if probe is None else tuple(x[None] for x in probe)


def aggregate_product(params: qnn.Params, ks_all: List[torch.Tensor],
                      weights: torch.Tensor, eps, *, impl: str = "xla",
                      factors=None) -> qnn.Params:
    """Eq. 6: U^{l,j} = prod_{k=I_l}^{1} prod_n e^{i eps w_n K_{n,k}},
    then U_{t+1} = U^{l,j} U_t^{l,j}. factors: optional per-layer eigh
    factors of the unscaled K's from the node pass."""
    fac = None if factors is None else [(lam[None], v[None])
                                        for lam, v in factors]
    return _unone(_product(_one(params), _one(ks_all), weights[None], eps,
                           impl, fac))


def aggregate_average(params: qnn.Params, ks_all: List[torch.Tensor],
                      weights: torch.Tensor, eps, *, impl: str = "xla"
                      ) -> qnn.Params:
    """Eq. 8: K_k = sum_n w_n K_{n,k};  U = prod_{k=I_l}^{1} e^{i eps K_k}."""
    k_bars = [_weighted_mean(ks[None], weights[None]) for ks in ks_all]
    return _unone(_average(_one(params), None, k_bars, eps, 0.0, "none",
                           impl)[0])


def select_phase(dataset: QuantumDataset, gen: torch.Generator,
                 cfg: QuantumFedConfig):
    """Phase 1: ``(sel, pmask, weights)`` for one round; the weights are
    the float32 Alg. 2 weights of the selected nodes, paired with the
    schedule (``participation.round_weights``)."""
    check_supported(cfg)
    sel, pmask, weights = _select(_one_dataset(dataset), [gen], cfg)
    return sel[0], pmask[0], weights[0]


def local_phase(params: qnn.Params, dataset: QuantumDataset,
                sel: torch.Tensor, gen: torch.Generator,
                cfg: QuantumFedConfig, with_factors: bool = False,
                with_bound: bool = False):
    """Phase 2: the QuanFedNode pass of every selected node; per layer
    (N_p, I_l, m, d, d), plus the eigh factors with ``with_factors`` and
    the (N_p,) per-node certificates with ``with_bound``."""
    check_supported(cfg)
    cfg, mesh = _round_statics(cfg)
    out = _local(_one(params), _one_dataset(dataset),
                 sel.to(dataset.phi_in.device)[None], [gen], cfg.eta,
                 cfg.eps, cfg, with_factors, with_bound, mesh)
    if not isinstance(out, tuple):
        return _unone(out)
    res = [_unone(out[0])]
    if with_factors:
        res.append([(lam[0], v[0]) for lam, v in out[1]])
    if with_bound:
        res.append(out[-1][0])
    return tuple(res)


def transmit_phase(ks_all: List[torch.Tensor], gen: torch.Generator,
                   cfg: QuantumFedConfig) -> List[torch.Tensor]:
    """Phase 3: channel model, then the strategy's wire cast."""
    return _unone(_transmit(_one(ks_all), [gen], cfg))


def aggregate_phase(params: qnn.Params, ks_all: List[torch.Tensor],
                    weights: torch.Tensor, cfg: QuantumFedConfig,
                    smom=None, server_opt: str = "none",
                    server_beta: float = 0.9, probe=None, factors=None):
    """Phase 4: the strategy's combine into the global model; returns
    ``(new_params, new_smom)``. ``ks_all`` may stack any number of
    uploads. smom: per-layer (I_l, m, d, d) momentum, None for the zero
    round-0 state. probe: the server's (phi_in, phi_out) screening batch
    for ``cfg.defense == "screen"``. factors: the node pass's eigh
    factors, valid when ``_factors_survive_wire(cfg)``."""
    check_supported(cfg)
    cfg, mesh = _round_statics(cfg)
    fac = None if factors is None else [(lam[None], v[None])
                                        for lam, v in factors]
    new_params, new_smom = _aggregate(
        _one(params), _one(smom), _one(ks_all), weights[None], cfg.eps,
        server_beta, cfg, server_opt, fac, _one_probe(probe), mesh)
    return _unone(new_params), _unone(new_smom)


def server_round_certified(params: qnn.Params, dataset: QuantumDataset,
                           gen: torch.Generator, cfg: QuantumFedConfig,
                           smom=None, server_opt: str = "none",
                           server_beta: float = 0.9, probe=None):
    """One QuanFedPS iteration that also returns the round's
    approximation-error certificate: ``(new_params, new_smom,
    err_bound)``. new_smom: the server momentum state (None for
    ``server_opt="none"``). err_bound is a float64 scalar bounding the
    total max-abs deviation of the round's update matrices from the
    exact engine's, sum_n w_n bound_n over the selected nodes; exactly
    0.0 with the approximate-rank knobs off, where the new params are
    those of ``server_round_opt`` bit for bit."""
    check_supported(cfg)
    fserver_opt.validate(server_opt)
    cfg, mesh = _round_statics(cfg)
    new_params, new_smom, err = _round(
        _one(params), _one(smom), _one_dataset(dataset), [gen], None,
        cfg.eta, cfg.eps, server_beta, cfg, server_opt, _one_probe(probe),
        certify=True, mesh=mesh)
    return _unone(new_params), _unone(new_smom), err[0]


def server_round_opt(params: qnn.Params, smom, dataset: QuantumDataset,
                     gen: torch.Generator, cfg: QuantumFedConfig,
                     server_opt: str = "none", server_beta: float = 0.9,
                     probe=None):
    """``server_round`` threading the server-optimiser momentum state:
    returns ``(new_params, new_smom)`` (new_smom None when server_opt is
    "none"). probe: the server's (phi_in, phi_out) screening batch,
    required when ``cfg.defense == "screen"``."""
    check_supported(cfg)
    fserver_opt.validate(server_opt)
    cfg, mesh = _round_statics(cfg)
    new_params, new_smom, _ = _round(
        _one(params), _one(smom), _one_dataset(dataset), [gen], None,
        cfg.eta, cfg.eps, server_beta, cfg, server_opt, _one_probe(probe),
        certify=False, mesh=mesh)
    return _unone(new_params), _unone(new_smom)


def server_round(params: qnn.Params, dataset: QuantumDataset,
                 gen: torch.Generator, cfg: QuantumFedConfig) -> qnn.Params:
    """One QuanFedPS iteration: select -> local -> transmit -> aggregate."""
    return server_round_opt(params, None, dataset, gen, cfg)[0]


def server_round_stacked(params: qnn.Params, dataset: QuantumDataset,
                         gens_or_sels, cfg: QuantumFedConfig, *,
                         smom=None, eta=None, eps=None,
                         server_opt: str = "none", server_beta=None,
                         probe=None):
    """One QuanFedPS round for a STACK of S independent federations of
    one structural config (the multi-tenant serving hot path).

    Every argument carries a leading session axis S: ``params`` per
    layer (S, m, d, d), ``dataset`` a ``QuantumDataset`` with every field
    stacked, ``smom`` per layer (S, I_l, m, d, d) or None, ``probe``
    (phi_in, phi_out) each (S, X, d). ``gens_or_sels``: S generators,
    session s drawing its selection, minibatches and channel from the
    s-th as a solo round would; or an (S, N_p) tensor of selections,
    whose weights are then the selected nodes' data volumes with every
    node kept (no other draw may be needed: GD and the identity
    channel). ``eta`` / ``eps`` / ``server_beta`` are scalars or (S,)
    tensors (None: cfg.eta, cfg.eps, 0.9).

    The node pass runs over S * N_p nodes and the combine chains over
    (S * m, d, d), so the round launches as many kernels as one solo
    round. Returns ``(new_params, new_smom, err_bounds)``, err_bounds
    (S,) float64 (zeros for exact configs)."""
    check_supported(cfg)
    fserver_opt.validate(server_opt)
    # a pod mesh spreads the nodes of ONE federation, not the sessions
    cfg = cfg._replace(fanout="vmap")
    dev = params[0].device
    if torch.is_tensor(gens_or_sels):
        gens, sel = None, gens_or_sels
        needs = [name for name, on in (
            ("minibatch", cfg.minibatch is not None),
            ("a channel", not isinstance(fchannel.resolve_channel(
                cfg.upload_noise, cfg.quantize_bits),
                fchannel.IdentityChannel)),
            ("dropout", cfg.participation == "dropout")) if on]
        if needs:
            raise ValueError("injected selections leave no generator for "
                             f"{', '.join(needs)}: pass one generator per "
                             "session instead")
    else:
        gens, sel = list(gens_or_sels), None
    s = params[0].shape[0]
    if (sel.shape[0] if gens is None else len(gens)) != s:
        raise ValueError(f"{s} sessions in params, but "
                         f"{sel.shape[0] if gens is None else len(gens)} "
                         "generators or selections")

    def vec(v, default):
        v = default if v is None else v
        return torch.as_tensor(v, dtype=torch.float64, device=dev).expand(s)

    return _round(params, smom, dataset, gens, sel, vec(eta, cfg.eta),
                  vec(eps, cfg.eps), vec(server_beta, 0.9), cfg, server_opt,
                  probe, certify=_approx_on(cfg))


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


def train(key: int, cfg: QuantumFedConfig, dataset: QuantumDataset,
          test: Tuple[torch.Tensor, torch.Tensor], n_iterations: int,
          params: Optional[qnn.Params] = None, eval_every: int = 1,
          verbose: bool = False) -> Tuple[qnn.Params, Dict[str, list]]:
    """DEPRECATED shim over ``repro_torch.core.fed.api`` — prefer
    ``FederationSession`` (checkpointable, resumable, hookable).

    Drives a session on the dataset's device with the pre-split
    round-key plan (``create(..., rounds=n_iterations)``) and the legacy
    eval cadence: round 0, every ``eval_every`` rounds and the last.
    ``key`` is the port's int seed (``repro_torch.core.fed.api.rng``),
    not a JAX key. Each record costs one host copy. Returns ``(params,
    history)``."""
    import warnings

    from repro_torch.core.fed import api

    warnings.warn("fed.train is a legacy shim; use repro_torch.core.fed."
                  "api.FederationSession", DeprecationWarning, stacklevel=2)
    spec = api.FedSpec.from_quantum_config(cfg)
    sub = api.QuantumSubstrate(spec, dataset=dataset, test=test,
                               device=dataset.phi_in.device)
    sess = api.FederationSession.create(spec, key, substrate=sub,
                                        params=params, rounds=n_iterations)
    sess.run(n_iterations,
             callbacks=[api.EvalEvery(eval_every, verbose=verbose)])
    return sess.state, sess.history
