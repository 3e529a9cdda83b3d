"""``Substrate`` — what a federation round runs ON (the port of
``repro.core.fed.api.substrate``).

The session's scheduler drives federations through this protocol and
never branches on which physics it is driving:

* ``init_state(key, params=None)`` — build the opaque federation state
  (global model + whatever server-optimizer state the substrate keeps).
* ``run_round(state, key, round)`` — one QuanFedPS synchronization
  iteration (Alg. 1 + Alg. 2): the CANONICAL composition of the four
  round phases (``repro_torch.core.fed.api.phases``), fused where the
  substrate can; returns ``(new_state, metrics)``.
* the four phases themselves — ``select`` / ``local_update`` /
  ``transmit`` / ``aggregate`` (+ ``split_round_key`` and
  ``upload_restore``) — for schedulers that interleave phases of
  different rounds (async buffering, overlapped dispatch).
* ``evaluate(state)`` — metric dict of PYTHON floats, copied from the
  device in ONE ``.cpu()`` of the stacked metrics (a single host sync
  per record, not one blocking ``.item()`` per metric).
* ``state_flat(state)`` / ``state_restore(flat)`` — the checkpoint
  boundary: a nested tree of tensors for ``repro_torch.checkpoint`` and
  its exact inverse, onto the substrate's device.

Keys are the port's int round keys (``repro_torch.core.fed.api.rng``).
``QuantumSubstrate`` wraps the ``core/quantum/federated`` phases;
``ClassicalSubstrate`` wraps ``core/fed/fed_step``'s (``node_uploads`` /
``aggregate_deltas``) plus the per-node inner-optimizer state.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Protocol, Tuple

import torch

from repro_torch.core.fed import channel as fchannel
from repro_torch.core.fed import fed_step, participation
from repro_torch.core.fed import server_opt as fserver_opt
from repro_torch.core.fed.api import rng
from repro_torch.core.fed.api.phases import Cohort, compose_round
from repro_torch.core.fed.api.spec import FedSpec
from repro_torch.device import resolve_device
from repro_torch.optim.tree import tree_map


class Substrate(Protocol):
    """The physics-agnostic face a federation session drives."""

    spec: FedSpec
    device: torch.device

    def init_state(self, key: int, params: Any = None) -> Any:
        ...

    def run_round(self, state: Any, key: int, round: int
                  ) -> Tuple[Any, Dict[str, Any]]:
        ...

    def evaluate(self, state: Any) -> Dict[str, float]:
        ...

    def state_flat(self, state: Any) -> Dict[str, Any]:
        ...

    def state_restore(self, flat: Dict[str, Any]) -> Any:
        ...


def host_floats(tree) -> Dict[str, float]:
    """One host transfer for a (possibly nested) dict of scalar tensors:
    the leaves are stacked in float64 and copied with one ``.cpu()``;
    nested keys join with '_'."""
    names, vals = [], []

    def walk(prefix, t):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(f"{prefix}{k}" if not prefix else f"{prefix}_{k}", v)
        else:
            names.append(prefix)
            vals.append(torch.as_tensor(t).reshape(()).to(torch.float64))

    walk("", tree)
    if not names:
        return {}
    host = torch.stack([v.to(vals[0].device) for v in vals]).cpu().tolist()
    return dict(zip(names, host))


class QuantumSubstrate:
    """QuanFedPS on the dissipative-QNN simulator (Alg. 1/2 proper).

    State is the QNN params: a list of per-layer stacked complex
    unitaries — or, with ``spec.server_opt != "none"``, the dict
    ``{"params": [...], "smom": [...] | None}`` carrying the server
    momentum on the aggregated generators (None until the first
    aggregation). With the certified approximate-rank engine on
    (``spec.rank_tol`` / ``rank_cap`` / ``ensemble_dtype``) the state is
    always the dict form and additionally carries ``"err_bound"`` — the
    RUNNING sum of per-round error certificates; each round's increment
    is reported in the round metrics and ``evaluate`` surfaces the
    accumulated total alongside fidelity.

    Pass ``dataset``/``test`` explicitly (they are moved to ``device``),
    or leave them None to rebuild both from the spec's data recipe:
    the port's own ``data.make_federated_dataset`` on a generator seeded
    with ``spec.data_seed``. That recipe is deterministic, but its
    hidden target unitary and pairs are the port's, not the ones the
    reference draws from the same seed; to hold the two packages to one
    dataset, pass the reference's arrays (``repro_torch.convert``).
    Every tensor the substrate makes lives on ``device``.
    """

    def __init__(self, spec: FedSpec, dataset=None,
                 test: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 device="cuda"):
        from repro_torch.core.quantum import data as qdata
        from repro_torch.core.quantum import federated as fed
        from repro_torch.core.quantum import linalg as ql

        if spec.substrate != "quantum":
            raise ValueError(f"QuantumSubstrate needs a quantum spec, got "
                             f"{spec.substrate!r}")
        self.spec = spec
        self.device = resolve_device(device)
        self.cfg = fed.check_supported(spec.to_quantum_config())
        self._certified = ql.resolve_approx(
            spec.rank_tol, spec.rank_cap, spec.ensemble_dtype) is not None
        if (dataset is None) != (test is None):
            # regenerating one half from the recipe would pair it with a
            # DIFFERENT hidden target unitary than the provided half
            raise ValueError("pass both dataset= and test= (same target "
                             "unitary) or neither")
        if dataset is None:
            if spec.n_per_node is None and spec.node_sizes is None:
                raise ValueError(
                    "spec carries no data recipe (n_per_node / node_sizes)"
                    " — pass dataset= and test= explicitly")
            _, dataset, test = qdata.make_federated_dataset(
                torch.Generator(device="cpu").manual_seed(spec.data_seed),
                int(spec.widths[0]), num_nodes=spec.num_nodes,
                n_per_node=spec.n_per_node or 0,
                noise_ratio=spec.data_noise, iid=spec.data_iid,
                n_test=spec.n_test, node_sizes=spec.node_sizes,
                device=self.device)
        dev = self.device
        dataset = qdata.QuantumDataset(
            dataset.phi_in.to(dev), dataset.phi_out.to(dev),
            None if dataset.n_per is None else dataset.n_per.to(dev))
        test = (test[0].to(dev), test[1].to(dev))
        self.dataset = dataset
        self.test = test
        # defense="screen" scores each upload on a server probe batch —
        # the held-out test pairs double as the probe
        self._probe = test if spec.defense == "screen" else None
        # flattened train view for evaluation (padded slots masked out)
        self._train_in = dataset.phi_in.reshape(-1, dataset.phi_in.shape[-1])
        self._train_out = dataset.phi_out.reshape(
            -1, dataset.phi_out.shape[-1])
        vmask = dataset.valid_mask()
        self._train_w = None if vmask is None else vmask.reshape(-1)

    def _params_of(self, state):
        return state["params"] if isinstance(state, dict) else state

    def _smom_of(self, state):
        return state.get("smom") if isinstance(state, dict) else None

    def _err_of(self, state):
        if isinstance(state, dict) and "err_bound" in state:
            return state["err_bound"]
        return torch.zeros((), dtype=torch.float64, device=self.device)

    def _pack(self, params, smom, err_bound=None):
        if self.spec.server_opt == "none" and not self._certified:
            return params  # legacy state shape, bit-compatible ckpts
        state = {"params": params, "smom": smom}
        if self._certified:
            state["err_bound"] = (self._err_of(None) if err_bound is None
                                  else err_bound)
        return state

    def init_state(self, key: int, params: Any = None):
        from repro_torch.core.quantum import qnn
        if params is None:
            params = qnn.init_params(rng.generator(key), self.spec.widths,
                                     device=self.device)
        else:
            params = [p.to(self.device) for p in params]
        return self._pack(params, None)

    def run_round(self, state, key: int, round: int):
        from repro_torch.core.quantum import federated as fed
        del round  # the quantum round is pure in (state, key)
        params, smom, bound = fed.server_round_certified(
            self._params_of(state), self.dataset, rng.generator(key),
            self.cfg, smom=self._smom_of(state),
            server_opt=self.spec.server_opt,
            server_beta=self.spec.server_momentum, probe=self._probe)
        if not self._certified:
            return self._pack(params, smom), {}
        err = self._err_of(state) + bound
        return (self._pack(params, smom, err),
                {"err_bound_round": bound, "err_bound_total": err})

    # -- the four phases (see repro_torch.core.fed.api.phases) ----------
    def split_round_key(self, key: int):
        # the fused round draws selection, minibatches and channel from
        # ONE generator in that order; the phases share it the same way
        gen = rng.generator(key)
        return gen, gen, gen

    def select(self, gen: torch.Generator, round: int) -> Cohort:
        from repro_torch.core.quantum import federated as fed
        sel, pmask, weights = fed.select_phase(self.dataset, gen, self.cfg)
        return Cohort(sel=sel, mask=pmask, weights=weights, round=round)

    def local_update(self, state, cohort: Cohort, gen: torch.Generator):
        from repro_torch.core.quantum import federated as fed
        if not self._certified:
            ks_all = fed.local_phase(self._params_of(state), self.dataset,
                                     cohort.sel, gen, self.cfg)
            return state, ks_all, {}
        # certified engine: the cohort's per-node certificates combine
        # with its selection weights at dispatch time (the uploads are
        # approximate the moment they are born, whatever round they
        # later commit in) and accumulate into the state's running total
        ks_all, bounds = fed.local_phase(self._params_of(state),
                                         self.dataset, cohort.sel, gen,
                                         self.cfg, with_bound=True)
        bound = torch.sum(cohort.weights.to(bounds.dtype) * bounds)
        err = self._err_of(state) + bound
        state = self._pack(self._params_of(state), self._smom_of(state),
                           err)
        return state, ks_all, {"err_bound_round": bound,
                               "err_bound_total": err}

    def snapshot(self, state):
        return state  # the local phase changes nothing it is given

    def transmit(self, uploads, gen: torch.Generator):
        from repro_torch.core.quantum import federated as fed
        return fed.transmit_phase(uploads, gen, self.cfg)

    def aggregate(self, state, received, weights: torch.Tensor):
        from repro_torch.core.quantum import federated as fed
        params, smom = fed.aggregate_phase(
            self._params_of(state), received, weights, self.cfg,
            smom=self._smom_of(state), server_opt=self.spec.server_opt,
            server_beta=self.spec.server_momentum, probe=self._probe)
        return self._pack(params, smom, self._err_of(state))

    def upload_restore(self, flat: Dict[str, Any]):
        n_layers = len(self.spec.widths) - 1
        return [flat[str(i)].to(self.device) for i in range(n_layers)]

    # -- evaluation / checkpoint ----------------------------------------
    def evaluate(self, state) -> Dict[str, float]:
        from repro_torch.core.quantum import federated as fed
        params = self._params_of(state)
        tr = fed.evaluate(params, self._train_in, self._train_out,
                          self.spec.widths, impl=self.spec.impl,
                          weights=self._train_w)
        te = fed.evaluate(params, self.test[0], self.test[1],
                          self.spec.widths, impl=self.spec.impl)
        tree = {"train": tr, "test": te}
        if self._certified:
            # the certificate travels with fidelity: accumulated bound
            # on how far the approximate engine may have drifted
            tree["err_bound"] = self._err_of(state)
        return host_floats(tree)

    def state_flat(self, state) -> Dict[str, Any]:
        flat = {"params": list(self._params_of(state))}
        smom = self._smom_of(state)
        if smom is not None:
            flat["smom"] = list(smom)
        if self._certified:
            flat["err_bound"] = self._err_of(state)
        return flat

    def state_restore(self, flat: Dict[str, Any]):
        from repro_torch.core.quantum import linalg as ql
        n_layers = len(self.spec.widths) - 1
        dev = self.device

        def layers(name):
            # complex leaves of a 32-bit reference run widen to complex128
            return [flat[f"{name}/{i}"].to(dev, ql.DTYPE)
                    for i in range(n_layers)]
        params = layers("params")
        smom = (layers("smom") if any(k.startswith("smom/") for k in flat)
                else None)
        err = (flat["err_bound"].to(dev, torch.float64)
               if "err_bound" in flat else None)
        return self._pack(params, smom, err)

    # -- serving (stacked multi-tenant rounds) --------------------------
    def smom_zeros(self, params):
        """The zero server-momentum state, materialized: per layer
        (I_l,) + params[l].shape — the shape of the averaged generators
        K̄_k the momentum recursion runs on. Numerically identical to
        the lazy ``None`` round-0 state (``generator_step`` treats None
        as zeros), but structure-stable, so stacked session states keep
        one shape whatever round each tenant is at."""
        il = self.spec.interval_length
        return [torch.zeros((il,) + tuple(p.shape), dtype=p.dtype,
                            device=p.device) for p in params]

    def state_parts(self, state):
        """``(params, smom, err_bound)`` in a STRUCTURE-STABLE form —
        what the serving layer stacks over the session axis: ``smom``
        is materialized via ``smom_zeros`` when the spec carries a
        server optimizer but no momentum has accumulated yet, ``smom``
        / ``err_bound`` are None exactly when the spec never tracks
        them. ``pack_state`` is the inverse."""
        params = self._params_of(state)
        smom = self._smom_of(state)
        if self.spec.server_opt != "none" and smom is None:
            smom = self.smom_zeros(params)
        err = self._err_of(state) if self._certified else None
        return params, smom, err

    def pack_state(self, params, smom=None, err_bound=None):
        """Rebuild a session state from ``state_parts`` output (public
        face of ``_pack`` for the serving layer)."""
        return self._pack(params, smom, err_bound)


class ClassicalSubstrate:
    """QuanFedPS's classical limit: I_l local optimizer steps per node +
    weighted delta aggregation (``fed_step``) on a model.

    State is ``{"params": model params, "opt": per-node inner optimizer
    states}`` (+ ``"sopt"``, the server-side outer-optimizer state, when
    ``spec.server_opt != "none"``), in the reference's keys and shapes:
    the ``opt`` leaves carry a leading N_p axis. Data is a deterministic
    per-round pool stream rebuilt from the spec (seeded
    ``token_batches``, the reference's tokens bit for bit), so a resumed
    substrate fast-forwards the stream to the checkpointed round and
    continues bit-exactly. The model is ``Model(get_config(spec.arch)
    .reduced(...))`` unless one is passed; the data follows that reduced
    config, as in the reference.

    The local phase updates the ``opt`` state it is given IN PLACE (a
    full-width node's moments have no room for a second copy): see
    ``phases`` for the contract and ``snapshot``.
    """

    def __init__(self, spec: FedSpec, model=None, opt=None, device="cuda"):
        from repro_torch.configs import get_config
        from repro_torch.core.fed.config import FederatedConfig
        from repro_torch.data import token_batches
        from repro_torch.models import Model
        from repro_torch.optim import AdamW

        if spec.substrate != "classical":
            raise ValueError(f"ClassicalSubstrate needs a classical spec, "
                             f"got {spec.substrate!r}")
        if spec.arch is None:
            raise ValueError("classical spec needs arch")
        self.spec = spec
        self.device = resolve_device(device)
        reduced_kw = {} if spec.n_layers is None else {
            "n_layers": spec.n_layers}
        self.cfg = get_config(spec.arch).reduced(**reduced_kw)
        self.model = model if model is not None else Model(self.cfg)
        self.opt = opt if opt is not None else AdamW(weight_decay=0.0)
        self.loss_fn = lambda p, b: self.model.loss_fn(p, b)
        # fed_train_round sees only the SELECTED nodes: its num_nodes is
        # the per-round count N_p, not the global N
        self.fed_cfg = FederatedConfig(
            num_nodes=spec.nodes_per_round,
            nodes_per_round=spec.nodes_per_round,
            interval_length=spec.interval_length,
            aggregation=spec.aggregation,
            participation=spec.participation,
            dropout_rate=spec.dropout_rate, outer_lr=spec.outer_lr,
            delta_dtype=spec.delta_dtype)
        self._delta_dt = fed_step.resolve_delta_dtype(self.fed_cfg)
        self._server_sgd = fserver_opt.make_sgd(spec.server_opt,
                                                spec.server_momentum)
        # classical wire: quantization if the spec asks (Hermitian noise
        # is quantum-only — real deltas have no GUE perturbation)
        self._channel = fchannel.resolve_channel(0.0, spec.quantize_bits)
        self._pool_seqs = spec.node_pool_seqs or spec.node_batch * 2
        # unequal nodes: the pool must cover the requested true volumes
        self._pool_total = (sum(spec.node_sizes) if spec.node_sizes
                            else spec.num_nodes * self._pool_seqs)
        self._data = None
        self._pos = 0
        self.eval_batch = next(token_batches(
            self.cfg, spec.eval_batch, spec.seq_len,
            seed=spec.data_seed + 99, device=self.device))

    def _opt_nodes(self, params):
        return fed_step.replicate_for_pods(self.opt.init(params),
                                           self.spec.nodes_per_round)

    def init_state(self, key: int, params: Any = None):
        if params is None:
            params = self.model.init(seed=key, device=self.device)
        else:
            params = {k: v.to(self.device) for k, v in params.items()}
        state = {"params": params, "opt": self._opt_nodes(params)}
        if self._server_sgd is not None:
            state["sopt"] = self._server_sgd.init(params)
        return state

    def _pool(self, round: int):
        """The round's global data pool — the ``round``-th item of the
        seeded stream, regardless of what was consumed before (rewinds
        by recreating the iterator, fast-forwards by draining it)."""
        from repro_torch.data import token_batches
        if self._data is None or self._pos > round:
            self._data = token_batches(
                self.cfg, self._pool_total, self.spec.seq_len,
                seed=self.spec.data_seed, device=self.device)
            self._pos = 0
        while self._pos < round:
            next(self._data)
            self._pos += 1
        pool = next(self._data)
        self._pos += 1
        return pool

    def run_round(self, state, key: int, round: int):
        # the canonical phase composition, executed as it stands
        return compose_round(self, state, key, round)

    # -- the four phases (see repro_torch.core.fed.api.phases) ----------
    def split_round_key(self, key: int):
        # selection draws from the round key's own generator; the local
        # phase draws nothing; the channel's generator is a fresh
        # derivation (only the quantize channel draws from it)
        return (rng.generator(key), rng.fold_in(key, 1),
                rng.generator(rng.fold_in(key, 2)))

    def select(self, gen: torch.Generator, round: int) -> Cohort:
        from repro_torch.data import (node_token_counts, partition_iid,
                                      partition_non_iid)

        spec = self.spec
        pool = self._pool(round)
        nodes = (partition_iid(pool, spec.num_nodes,
                               seed=spec.data_seed + round,
                               node_seqs=spec.node_sizes)
                 if spec.data_iid else
                 partition_non_iid(pool, spec.num_nodes,
                                   node_seqs=spec.node_sizes))
        # TRUE per-node token counts from the partition (Alg. 2's N_n) —
        # weighted participation / data-volume rounds see real volumes
        node_tokens = node_token_counts(nodes)
        nodes.pop("n_seqs", None)  # counts consumed; not a batch entry
        sel, pmask = participation.sample_nodes(
            gen, spec.num_nodes, spec.nodes_per_round, device=self.device,
            schedule=spec.participation, node_sizes=node_tokens,
            dropout_rate=spec.dropout_rate,
            method=spec.participation_method)
        il = spec.interval_length

        def to_steps(x):  # the selected nodes' pools as I_l local steps
            x = x[sel]
            per = x.shape[1] // il
            return x[:, : per * il].reshape(
                (x.shape[0], il, per) + tuple(x.shape[2:]))

        weights = participation.round_weights(
            self.fed_cfg.participation, node_tokens[sel].to(torch.float32),
            pmask.to(torch.float32))
        return Cohort(sel=sel, mask=pmask, weights=weights, round=round,
                      data={k: to_steps(v) for k, v in nodes.items()})

    def local_update(self, state, cohort: Cohort, key):
        del key  # the classical local pass draws no randomness
        deltas, opt_nodes, metrics = fed_step.node_uploads(
            self.loss_fn, self.opt, state["params"], state["opt"],
            cohort.data, self.spec.lr, self._delta_dt)
        state = dict(state, opt=opt_nodes)
        return state, deltas, {k: v.mean() for k, v in metrics.items()}

    def snapshot(self, state):
        # the local phase consumes only the inner optimizer states
        return dict(state, opt=tree_map(torch.clone, state["opt"]))

    def transmit(self, uploads, gen: torch.Generator):
        return self._channel(gen, uploads)

    def aggregate(self, state, received, weights: torch.Tensor):
        params, sopt = fed_step.aggregate_deltas(
            state["params"], received, weights, self.spec.outer_lr,
            server_sgd=self._server_sgd, server_state=state.get("sopt"),
            defense=self.spec.defense, trim_frac=self.spec.trim_frac,
            clip_norm=self.spec.clip_norm)
        state = dict(state, params=params)
        if self._server_sgd is not None:
            state["sopt"] = sopt
        return state

    def upload_restore(self, flat: Dict[str, Any]):
        # a delta tree mirrors the params tree: a FLAT dict of tensors
        return {k: v.to(self.device) for k, v in flat.items()}

    # -- evaluation / checkpoint ----------------------------------------
    def evaluate(self, state) -> Dict[str, float]:
        with torch.no_grad():
            loss = self.loss_fn(state["params"], self.eval_batch)[0]
        return host_floats({"eval_loss": loss})

    def state_flat(self, state) -> Dict[str, Any]:
        flat = {"params": state["params"], "opt": state["opt"]}
        if "sopt" in state:
            flat["sopt"] = state["sopt"]
        return flat

    def state_restore(self, flat: Dict[str, Any]):
        from repro_torch import checkpoint as ckpt
        dev = self.device
        # model params are a FLAT dict with '/' in its keys — stripping
        # the "params/" prefix recovers exactly the original keys
        params = {k[len("params/"):]: v.to(dev)
                  for k, v in flat.items() if k.startswith("params/")}
        meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in params.items()}

        def restore(tpl, prefix):
            # each leaf where the optimizer's own init puts it: the step
            # counter on the host, the rest on the substrate's device
            tree = ckpt.unflatten_like(
                tpl, {k[len(prefix):]: v for k, v in flat.items()
                      if k.startswith(prefix)}, device="cpu")
            return tree_map(lambda t, x: x.to(dev if t.is_meta
                                              else t.device), tpl, tree)
        state = {"params": params,
                 "opt": restore(self._opt_nodes(meta), "opt/")}
        if self._server_sgd is not None:
            state["sopt"] = restore(self._server_sgd.init(meta), "sopt/")
        return state


def make_substrate(spec: FedSpec, device="cuda") -> Substrate:
    """Build the substrate a spec names, data included (the spec must
    carry a data recipe — see ``FedSpec``) on ``device``."""
    if spec.substrate == "quantum":
        return QuantumSubstrate(spec, device=device)
    return ClassicalSubstrate(spec, device=device)
