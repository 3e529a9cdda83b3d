"""Dissipative quantum neural network (Beer et al. 2020), the port of
``repro.core.quantum.qnn``.

A network is a tuple of widths ``(m_0, ..., m_L)``; layer ``l`` owns
``m_l`` perceptron unitaries of dimension ``2**(m_{l-1}+1)``, stacked as
``(m_l, d, d)``.

Engines (``update_matrices(engine=...)``): ``"local"`` runs both Prop.-1
chains as rank-bounded state-vector ensembles (see the reference module
for the derivations), exactly or, with the approximate-rank knobs, as
SVD-truncated ensembles with a certificate on the error;
``"local_opb"`` keeps the vector A chain but peels B as a 2**n x 2**n
operator (``apply_unitary_local``) with one av^H B_j product per
perceptron, the baseline; ``"dense"`` is the full-space oracle
(``dense_ref``). The operator-space layer channels (``layer_forward``,
``layer_adjoint``, ``feedforward``, ``backward``) are the local
contractions of the seed's dense forms.

Node axis: where the reference ``vmap``s a node pass, the port carries an
explicit leading node axis. A layer of params may be ``(m, d, d)`` or
``(P, m, d, d)``, with states ``(X, d)`` or ``(P, X, d)`` to match; every
node applies its own unitaries and the Prop.-1 sums never cross nodes.

``impl`` selects the backend of the inner products: ``"xla"`` is plain
complex128 PyTorch (the reference's einsum path, including the
adjoint-applied update), ``"pallas"`` the port's hand-written CUDA
kernels (``repro_torch.kernels``; their plain fp32 versions on the CPU),
with the explicit B-ensemble form of the update the fused trace kernel
consumes.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.core.quantum import dense_ref
from repro_torch.core.quantum import linalg as ql
from repro_torch.kernels import ops as kops

Params = List[torch.Tensor]
IMPLS = ("xla", "pallas")
ENGINES = ("local", "local_opb", "dense")


def perceptron_dim(m_in: int) -> int:
    return ql.dim(m_in + 1)


def _acting(m_in: int, j: int) -> List[int]:
    """Qubit axes perceptron j touches: all inputs plus output qubit j."""
    return list(range(m_in)) + [m_in + j]


def _check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; use one of {IMPLS}")


def bmm(a: torch.Tensor, b: torch.Tensor, *, impl: str = "xla"
        ) -> torch.Tensor:
    """Batched complex matmul a @ b (identical leading batch axes);
    impl="pallas" flattens the batch into the zgemm kernel."""
    _check_impl(impl)
    if impl == "xla":
        return a @ b
    batch = a.shape[:-2]
    out = kops.complex_matmul(a.reshape((-1,) + a.shape[-2:]),
                              b.reshape((-1,) + b.shape[-2:]))
    return out.reshape(batch + out.shape[-2:])


def batched_fidelity(phi: torch.Tensor, rho: torch.Tensor, *,
                     impl: str = "xla") -> torch.Tensor:
    """<phi| rho |phi> with kernel dispatch (batched over leading axes)."""
    _check_impl(impl)
    if impl == "xla":
        return ql.fidelity_pure(phi, rho)
    batch = phi.shape[:-1]
    out = kops.fidelity(phi.reshape((-1,) + phi.shape[-1:]),
                        rho.reshape((-1,) + rho.shape[-2:]))
    return out.reshape(batch)


def batched_mse(phi: torch.Tensor, rho: torch.Tensor, *,
                impl: str = "xla") -> torch.Tensor:
    """|| rho - |phi><phi| ||_F^2 with kernel dispatch (Eq. 10 term)."""
    _check_impl(impl)
    if impl == "xla":
        return ql.mse_state(phi, rho)
    batch = phi.shape[:-1]
    out = kops.mse(phi.reshape((-1,) + phi.shape[-1:]),
                   rho.reshape((-1,) + rho.shape[-2:]))
    return out.reshape(batch)


def init_params(gen: torch.Generator, widths: Sequence[int],
                dtype=ql.DTYPE, device="cuda") -> Params:
    """Haar initialization of all perceptron unitaries (Alg. 2 step 1)."""
    return [ql.haar_unitary(gen, perceptron_dim(widths[l - 1]),
                            batch=(widths[l],), dtype=dtype, device=device)
            for l in range(1, len(widths))]


def layer_forward(us: torch.Tensor, rho_in: torch.Tensor, m_in: int,
                  m_out: int) -> torch.Tensor:
    """Apply the layer channel E^l to a (batched) density matrix:
    tr_in(U (rho ⊗ |0..0><0..0|) U^H), U = U_m ... U_1, each U_j
    contracted on its acting qubits. us: (*B, m, d, d); rho_in:
    (*B, *X, 2**m_in, 2**m_in)."""
    n = m_in + m_out
    p0 = ql.zero_projector(m_out, dtype=rho_in.dtype, device=rho_in.device)
    full = torch.einsum("...ab,cd->...acbd", rho_in, p0)
    d = ql.dim(n)
    full = full.reshape(rho_in.shape[:-2] + (d, d))
    for j in range(m_out):
        full = ql.apply_unitary_local(full, _u(us, j), _acting(m_in, j), n)
    return ql.partial_trace(full, keep=list(range(m_in, n)), n_qubits=n)


def layer_adjoint(us: torch.Tensor, sigma: torch.Tensor, m_in: int,
                  m_out: int) -> torch.Tensor:
    """Adjoint channel F^l: sigma^l -> sigma^{l-1},
    F(Y) = (I ⊗ <0..0|) U^H (I ⊗ Y) U (I ⊗ |0..0>)."""
    n = m_in + m_out
    d_in, d_out = ql.dim(m_in), ql.dim(m_out)
    eye_in = torch.eye(d_in, dtype=sigma.dtype, device=sigma.device)
    full = torch.einsum("ab,...cd->...acbd", eye_in, sigma)
    full = full.reshape(sigma.shape[:-2] + (d_in * d_out, d_in * d_out))
    # U = U_m ... U_1  =>  U^H X U = U_1^H ... U_m^H X U_m ... U_1
    for j in range(m_out - 1, -1, -1):
        full = ql.apply_unitary_local(full, ql.dagger(_u(us, j)),
                                      _acting(m_in, j), n)
    # the sandwich with (I ⊗ |0..0>): the output block (0, 0)
    t = full.reshape(sigma.shape[:-2] + (d_in, d_out, d_in, d_out))
    return t[..., :, 0, :, 0]


def feedforward(params: Params, rho_in: torch.Tensor, widths: Sequence[int]
                ) -> List[torch.Tensor]:
    """[rho^0, rho^1, ..., rho^L] (Eq. 2), batched."""
    rhos = [rho_in]
    for l in range(1, len(widths)):
        rhos.append(layer_forward(params[l - 1], rhos[-1],
                                  widths[l - 1], widths[l]))
    return rhos


def backward(params: Params, sigma_out: torch.Tensor, widths: Sequence[int]
             ) -> List[torch.Tensor]:
    """[sigma^0, ..., sigma^L] with sigma^L the label density."""
    sigmas = [sigma_out]
    for l in range(len(widths) - 1, 0, -1):
        sigmas.append(layer_adjoint(params[l - 1], sigmas[-1],
                                    widths[l - 1], widths[l]))
    return sigmas[::-1]


def _append_ancilla(v: torch.Tensor, m_out: int) -> torch.Tensor:
    """|v> ⊗ |0..0>_{m_out} for ensemble vectors v: (..., d_in)."""
    full = torch.zeros(v.shape + (ql.dim(m_out),), dtype=v.dtype,
                       device=v.device)
    full[..., 0] = v
    return full.reshape(v.shape[:-1] + (-1,))


def _u(us: torch.Tensor, j: int) -> torch.Tensor:
    """Perceptron j's unitary of a layer stack (..., m, d, d)."""
    return us[..., j, :, :]


def _zeros_err(like: torch.Tensor) -> torch.Tensor:
    """A float64 error accumulator of batch shape like.shape[:-1]."""
    return torch.zeros(like.shape[:-1], dtype=torch.float64,
                       device=like.device)


def feedforward_ensemble(params: Params, phi_in: torch.Tensor,
                         widths: Sequence[int], *, compress: bool = False,
                         approx: Optional[ql.ApproxCfg] = None,
                         with_err: bool = False):
    """Propagate pure inputs as unnormalized ensembles: [v^0, ..., v^L]
    with v^l of shape (..., E_l, 2**m_l) and rho^l = sum_e v_e v_e^H.
    compress=True QR-compresses each ensemble to its rank bound.

    approx: the certified approximate-rank policy. Compression becomes
    SVD truncation to E_l <= min(2**m_l, rank_cap) at rank_tol, the
    ensembles and unitaries are held in the policy's storage dtype, and
    each compression's trace-norm loss adds up per example along the
    chain (CPTP layers are trace-norm contractive, so the sum bounds
    ||rho^l_approx - rho^l||_tr). approx=None is the exact path as it
    was. with_err=True also returns the per-layer accumulated errors
    (float64, zeros when approx is None)."""
    vs = [phi_in[..., None, :]]
    errs = None
    if approx is not None:
        vs[0] = ql.ensemble_store(vs[0], approx)
        errs = [_zeros_err(phi_in)]
    for l in range(1, len(widths)):
        m_in, m_out = widths[l - 1], widths[l]
        n = m_in + m_out
        v = vs[-1]
        if approx is None:
            if compress and v.shape[-2] > v.shape[-1]:
                v = ql.ensemble_compress(v)
                vs[-1] = v
            us = params[l - 1]
        else:
            d = v.shape[-1]
            target = min(d, approx.rank_cap or d)
            if v.shape[-2] > target or (approx.rank_tol > 0.0
                                        and v.shape[-2] > 1):
                v, e = ql.ensemble_compress(v, approx, with_err=True)
                v = ql.ensemble_store(v, approx)
                vs[-1] = v
                errs[-1] = errs[-1] + e.to(torch.float64)
            us = ql.ensemble_store(params[l - 1], approx)
        w = _append_ancilla(v, m_out)
        for j in range(m_out):
            w = ql.apply_unitary_vec(w, _u(us, j), _acting(m_in, j), n)
        # tr_in: the input factor folds into the ensemble axis
        w = w.reshape(w.shape[:-1] + (ql.dim(m_in), ql.dim(m_out)))
        vs.append(w.reshape(w.shape[:-3] + (-1, ql.dim(m_out))))
        if approx is not None:
            errs.append(errs[-1])
    if not with_err:
        return vs
    if errs is None:
        errs = [_zeros_err(phi_in) for _ in vs]
    return vs, errs


def _b_ensemble_chain(us: torch.Tensor, sv: torch.Tensor, m_in: int,
                      m_out: int, approx: Optional[ql.ApproxCfg] = None
                      ) -> List[torch.Tensor]:
    """One layer of the explicit ensemble B chain (the form the fused
    trace kernel consumes): B_m = I_in ⊗ sigma^l as the ensemble
    {e_i ⊗ s_f}, peeled downward with U^H vector contractions. Returns
    bvs with bvs[j] the B_{j+1} ensemble, (..., d_in*R', 2**n). approx
    holds the unitaries in its storage dtype (the caller compresses sv
    and accounts for the error).

    The reference takes its first peel through a one-hot shortcut; the
    port applies the same U^H as a plain vector contraction, which gives
    the same ensemble in the same layout."""
    n = m_in + m_out
    d_in, d_out = ql.dim(m_in), ql.dim(m_out)
    if sv.shape[-2] > sv.shape[-1]:
        sv = ql.ensemble_compress(sv)
    us = ql.ensemble_store(us, approx)
    eye_in = torch.eye(d_in, dtype=sv.dtype, device=sv.device)
    bv = torch.einsum("ij,...fo->...ifjo", eye_in, sv)
    bv = bv.reshape(sv.shape[:-2] + (d_in * sv.shape[-2], d_in * d_out))
    bvs = [bv]  # bvs[0] is B_{m_out}
    for jj in range(m_out - 1, 0, -1):
        bv = ql.apply_unitary_vec(bv, ql.dagger(_u(us, jj)),
                                  _acting(m_in, jj), n)
        bvs.append(bv)
    return bvs[::-1]


def _layer_basis_response(us: torch.Tensor, m_in: int, m_out: int
                          ) -> torch.Tensor:
    """psi_b = U_m ... U_1 (e_b ⊗ |0..0>) for every input basis vector:
    (..., d_in, 2**n), example-independent."""
    d_in = ql.dim(m_in)
    n = m_in + m_out
    psi = _append_ancilla(torch.eye(d_in, dtype=us.dtype, device=us.device),
                          m_out)
    psi = psi.expand(us.shape[:-3] + psi.shape)
    for j in range(m_out):
        psi = ql.apply_unitary_vec(psi, _u(us, j), _acting(m_in, j), n)
    return psi


def _sigma_step_ensemble(us: torch.Tensor, sv: torch.Tensor, m_in: int,
                         m_out: int, approx: Optional[ql.ApproxCfg] = None,
                         with_err: bool = False):
    """sigma^{l-1} ensemble from the sigma^l ensemble via the basis
    response: sigma^{l-1}[a, b] = sum_{g,i} conj(c[g,a,i]) c[g,b,i] with
    c[g,b,i] = sum_o conj(s_g[o]) psi_b[(i,o)], QR-compressed to <= d_in.

    us: (*B, m, d, d); sv: (*B, *X, R, d_out).

    approx switches both compressions to certified SVD truncation in the
    storage dtype; with_err=True also returns the step's truncation error
    (float64, batch-shaped, zeros when approx is None), an OPERATOR-norm
    budget: the adjoint channel is positive and unital, hence
    inf-norm contractive, and each dropped PSD term has operator norm at
    most its trace mass."""
    d_in, d_out = ql.dim(m_in), ql.dim(m_out)
    err = None
    if approx is None:
        if sv.shape[-2] > sv.shape[-1]:
            sv = ql.ensemble_compress(sv)
    else:
        err = _zeros_err(sv[..., 0])
        target_in = min(d_out, approx.rank_cap or d_out)
        if sv.shape[-2] > target_in:
            sv, e = ql.ensemble_compress(sv, approx, with_err=True)
            sv = ql.ensemble_store(sv, approx)
            err = err + e.to(torch.float64)
        us = ql.ensemble_store(us, approx)
    psi = _layer_basis_response(us, m_in, m_out)       # (*B, b, (i, o))
    nb = us.dim() - 3
    nx = sv.dim() - 2 - nb
    resp = psi.reshape(psi.shape[:-2] + (d_in * d_in, d_out))
    resp = resp.transpose(-1, -2)
    resp = resp.reshape(resp.shape[:nb] + (1,) * nx + resp.shape[nb:])
    c = sv.conj() @ resp                                # (..., g, (b, i))
    c = c.reshape(c.shape[:-1] + (d_in, d_in)).transpose(-1, -2)
    sv_prev = c.conj().reshape(c.shape[:-3] + (sv.shape[-2] * d_in, d_in))
    if approx is None:
        if sv_prev.shape[-2] > d_in:
            sv_prev = ql.ensemble_compress(sv_prev)
        return (sv_prev, _zeros_err(sv[..., 0])) if with_err else sv_prev
    target_out = min(d_in, approx.rank_cap or d_in)
    if sv_prev.shape[-2] > target_out or (approx.rank_tol > 0.0
                                          and sv_prev.shape[-2] > 1):
        sv_prev, e = ql.ensemble_compress(sv_prev, approx, with_err=True)
        sv_prev = ql.ensemble_store(sv_prev, approx)
        err = err + e.to(torch.float64)
    return (sv_prev, err) if with_err else sv_prev


def backward_ensemble(params: Params, phi_out: torch.Tensor,
                      widths: Sequence[int], *,
                      approx: Optional[ql.ApproxCfg] = None,
                      with_err: bool = False):
    """Back-propagate pure labels as state-vector ensembles, the mirror of
    ``feedforward_ensemble``: [w^0, ..., w^L] with w^l of shape
    (..., R_l, 2**m_l), sigma^l = sum_f w_f w_f^H, QR-compressed so
    R_l <= 2**m_l. approx truncates each step (certified); with_err=True
    also returns the per-layer accumulated OPERATOR-norm error bounds
    ||sigma^l_approx - sigma^l||_inf, aligned with the return (zeros when
    approx is None): each adjoint step is inf-norm contractive, so the
    per-step certificates add."""
    sv0 = phi_out[..., None, :]
    if approx is not None:
        sv0 = ql.ensemble_store(sv0, approx)
    svs, errs = [sv0], [_zeros_err(phi_out)]
    for l in range(len(widths) - 1, 0, -1):
        sv, e = _sigma_step_ensemble(params[l - 1], svs[-1], widths[l - 1],
                                     widths[l], approx=approx, with_err=True)
        svs.append(sv)
        errs.append(errs[-1] + e)
    if with_err:
        return svs[::-1], errs[::-1]
    return svs[::-1]


def density_from_ensemble(v: torch.Tensor, *, impl: str = "xla"
                          ) -> torch.Tensor:
    """rho = sum_e v_e v_e^H for ensembles v: (..., E, d)."""
    _check_impl(impl)
    if impl == "xla":
        return torch.einsum("...ed,...ec->...dc", v, v.conj())
    return bmm(v.transpose(-1, -2), v.conj(), impl=impl)


def _keep_major_stack(x: torch.Tensor, m_in: int, m_out: int
                      ) -> torch.Tensor:
    """(P, m, N, E, 2**n) per-perceptron stacks -> keep-major
    (P, m, N, E, dk, dr), perceptron j keeping its acting qubits."""
    n = m_in + m_out
    return torch.stack([ql.ensemble_keep_major(x[:, j], _acting(m_in, j), n)
                        for j in range(m_out)], dim=1)


def ensemble_commutator_traces(a_states: torch.Tensor,
                               b_states: torch.Tensor, m_in: int,
                               m_out: int) -> torch.Tensor:
    """T_j = sum_x tr_rest(A_{j,x} B_{j,x}) for all perceptrons of every
    node at once, through the fused trace kernel (the impl="pallas"
    update; impl="xla" takes the adjoint-applied form instead).

    a_states: (P, m_out, N, E_A, 2**n), b_states: (P, m_out, N, E_B, 2**n)
    in natural vector layout (P nodes, N examples per node). Returns
    (P, m_out, dk, dk), dk = 2**(m_in+1); the sum runs over N only.
    (P, m_out) is folded into the kernel's J axis (one launch), and the
    smaller ensemble goes second, the side the kernel folds through
    (tr_rest(AB) = tr_rest(BA)^H). Ensembles held in a reduced storage
    dtype are widened to complex128 here, the kernel's one dtype."""
    p, ea, eb = a_states.shape[0], a_states.shape[3], b_states.shape[3]
    dk = perceptron_dim(m_in)

    def km(x):
        t = _keep_major_stack(x.to(ql.DTYPE), m_in, m_out)
        return t.reshape((-1,) + t.shape[2:])
    if ea < eb:
        t = ql.dagger(kops.ensemble_commutator_trace(km(b_states),
                                                     km(a_states)))
    else:
        t = kops.ensemble_commutator_trace(km(a_states), km(b_states))
    return t.reshape(p, m_out, dk, dk)


def _ensemble_pair_traces(x_list: Sequence[torch.Tensor],
                          y_list: Sequence[torch.Tensor], m_in: int,
                          m_out: int) -> torch.Tensor:
    """T_j = sum_x tr_rest(sum_e |x_e><y_e|) for all j: x_list[j],
    y_list[j] are (P, N, E, 2**n); returns (P, m_out, dk, dk)."""
    xk = _keep_major_stack(torch.stack(list(x_list), 1), m_in, m_out)
    yk = _keep_major_stack(torch.stack(list(y_list), 1), m_in, m_out)
    return torch.einsum("pjnear,pjnebr->pjab", xk, yk.conj())


def _a_chains(params: Params, vs: Sequence[torch.Tensor],
              widths: Sequence[int], approx: Optional[ql.ApproxCfg] = None
              ) -> List[list]:
    """Per-perceptron A-chain stacks for every layer up front:
    chains[l-1][j] = U_{j+1} ... U_1 (v^{l-1} ⊗ |0..0>). Layers with
    identical (m_in, m_out), ensemble shape and dtype are stacked on a new
    leading axis and peeled together, one peel per perceptron index.
    approx holds the unitaries in its storage dtype."""
    L = len(widths) - 1
    prep = [(widths[l - 1], widths[l], _append_ancilla(vs[l - 1], widths[l]),
             ql.ensemble_store(params[l - 1], approx))
            for l in range(1, L + 1)]
    groups = {}
    for i, (m_in, m_out, av, _) in enumerate(prep):
        groups.setdefault((m_in, m_out, tuple(av.shape), av.dtype),
                          []).append(i)
    chains: List[list] = [None] * L
    for (m_in, m_out, _, _), idxs in groups.items():
        n = m_in + m_out
        w = torch.stack([prep[i][2] for i in idxs])
        ug = torch.stack([prep[i][3] for i in idxs])
        per = [[] for _ in idxs]
        for j in range(m_out):
            w = ql.apply_unitary_vec(w, _u(ug, j), _acting(m_in, j), n)
            for gi in range(len(idxs)):
                per[gi].append(w[gi])
        for gi, i in enumerate(idxs):
            chains[i] = per[gi]
    return chains


def _node_axis(params: Params, phi_in: torch.Tensor, phi_out: torch.Tensor,
               weights: Optional[torch.Tensor]):
    """(single, params, phi_in, phi_out, weights) with a node axis of one
    added where the params have none (single=True)."""
    if params[0].dim() != 3:
        return False, params, phi_in, phi_out, weights
    return (True, [p[None] for p in params], phi_in[None], phi_out[None],
            None if weights is None else weights[None])


def _weighted_label_ensemble(phi_out: torch.Tensor,
                             weights: Optional[torch.Tensor]):
    """(sigma^L ensemble, denom): the Prop.-1 weighted average scales the
    label VECTORS by sqrt(w_x), in float64 (phi_out: (P, X, d))."""
    sv = phi_out[..., None, :]
    if weights is None:
        return sv, phi_out.shape[-2]
    w = weights.to(sv.real.dtype)
    sv = sv * torch.sqrt(w)[..., None, None].to(sv.dtype)
    denom = torch.clamp(torch.sum(w, dim=-1), min=1e-12)
    return sv, denom[:, None, None, None]


def update_matrices(params: Params, phi_in: torch.Tensor,
                    phi_out: torch.Tensor, widths: Sequence[int], eta, *,
                    engine: str = "local", impl: str = "xla",
                    weights: Optional[torch.Tensor] = None,
                    rank_tol: float = 0.0, rank_cap: Optional[int] = None,
                    ensemble_dtype: Optional[str] = None,
                    with_bound: bool = False):
    """Proposition 1: the closed-form Hermitian update matrices

        K_j^l = eta * 2^{m_{l-1}} * i / N * sum_x tr_rest [A_x^{l,j}, B_x^{l,j}].

    params: layers (m, d, d) with phi_in (X, 2**m_0), phi_out (X, 2**m_L),
    or layers (P, m, d, d) with (P, X, .) states for P nodes at once.
    weights: optional (X,) / (P, X) real per-example weights (e.g. the
    validity mask of padded nodes); the average becomes
    sum_x w_x M_x / sum_x w_x. Returns a list like params of stacked K's.

    engine: "local" (ensembles on both chains), "local_opb" (operator B
    chain, ``_update_matrices_opb``) or "dense" (``dense_ref``).

    Certified approximate rank (engine="local" only): rank_tol, rank_cap
    and ensemble_dtype select SVD-truncated ensembles and reduced storage
    (``linalg.resolve_approx``). with_bound=True returns (Ks, bound), the
    bound a certificate on the max-abs entrywise deviation of the K's
    from the exact engine's, summed over layers:

        sum_l eta 2^{m_in} / denom * sum_x 2 (eA_x w_x + eB_x)

    with eA_x the accumulated forward trace-norm loss and eB_x the
    backward operator-norm loss (``update_matrices`` of the reference
    derives it). It is a scalar, or (P,) per node with the node axis,
    and exactly 0.0 when every knob is at its default, which runs the
    exact path unchanged. Storage-dtype rounding is not covered.
    """
    _check_impl(impl)
    approx = ql.resolve_approx(rank_tol, rank_cap, ensemble_dtype)
    single = params[0].dim() == 3
    if engine in ("dense", "local_opb"):
        if approx is not None:
            raise ValueError(
                "approximate rank (rank_tol/rank_cap/ensemble_dtype) is "
                f"engine='local' only; engine={engine!r} is an exact "
                "oracle/baseline")
        if engine == "dense":
            ks = dense_ref.update_matrices(params, phi_in, phi_out, widths,
                                           eta, weights=weights)
        else:
            ks = _update_matrices_opb(params, phi_in, phi_out, widths, eta,
                                      impl=impl, weights=weights)
        if not with_bound:
            return ks
        return ks, torch.zeros(() if single else params[0].shape[:1],
                               dtype=torch.float64, device=phi_in.device)
    if engine != "local":
        raise ValueError(f"unknown engine {engine!r}; use one of {ENGINES}")

    single, params, phi_in, phi_out, weights = _node_axis(
        params, phi_in, phi_out, weights)
    if approx is None:
        vs = feedforward_ensemble(params, phi_in, widths, compress=True)
        errs_a = None
    else:
        vs, errs_a = feedforward_ensemble(params, phi_in, widths,
                                          compress=True, approx=approx,
                                          with_err=True)
    sv, denom = _weighted_label_ensemble(phi_out, weights)
    a_chains = _a_chains(params, vs, widths, approx=approx)
    bound = torch.zeros(phi_in.shape[:1], dtype=torch.float64,
                        device=phi_in.device)
    if approx is not None:
        sv = ql.ensemble_store(sv, approx)
        err_b = _zeros_err(phi_out)
        wv = (torch.ones_like(err_b) if weights is None
              else weights.to(torch.float64))
        per_node = denom.reshape(-1) if torch.is_tensor(denom) else denom

    ks_rev: Params = []
    for l in range(len(widths) - 1, 0, -1):
        us = params[l - 1]
        m_in, m_out = widths[l - 1], widths[l]
        n = m_in + m_out
        if approx is None:
            if sv.shape[-2] > sv.shape[-1]:
                sv = ql.ensemble_compress(sv)
            us_c = us
        else:
            target = min(sv.shape[-1], approx.rank_cap or sv.shape[-1])
            if sv.shape[-2] > target:
                sv, e = ql.ensemble_compress(sv, approx, with_err=True)
                sv = ql.ensemble_store(sv, approx)
                err_b = err_b + e.to(torch.float64)
            us_c = ql.ensemble_store(us, approx)
        a_chain = a_chains[l - 1]
        if impl == "pallas":
            t = ensemble_commutator_traces(
                torch.stack(a_chain, 1),
                torch.stack(_b_ensemble_chain(us, sv, m_in, m_out,
                                              approx=approx), 1),
                m_in, m_out)
        else:
            # adjoint-applied form: y^{(j)} = B_j a^{(j)} via the recursion
            # y^{(j)} = U_{j+1}^H y^{(j+1)}, seeded by (I ⊗ sigma^l) a^{(m)}
            sigma_op = density_from_ensemble(sv)
            d_in, d_out = ql.dim(m_in), ql.dim(m_out)
            a_top = a_chain[-1].reshape(a_chain[-1].shape[:-1]
                                        + (d_in, d_out))
            y = torch.einsum("...op,...eip->...eio", sigma_op, a_top)
            y = y.reshape(a_chain[-1].shape)
            y_chain = [y]
            for jj in range(m_out - 1, 0, -1):
                y = ql.apply_unitary_vec(y, ql.dagger(_u(us_c, jj)),
                                         _acting(m_in, jj), n)
                y_chain.append(y)
            t = _ensemble_pair_traces(a_chain, y_chain[::-1], m_in, m_out)
            if approx is not None and approx.dtype is not None:
                t = t.to(ql.DTYPE)          # complex128 at the trace
        ks_rev.append((eta * (2.0 ** m_in) * 1j / denom)
                      * (t - ql.dagger(t)))
        if approx is not None:
            bound = bound + (eta * (2.0 ** m_in) / per_node) * torch.sum(
                2.0 * (errs_a[l - 1] * wv + err_b), dim=-1)
        if l > 1:
            if approx is None:
                sv = _sigma_step_ensemble(us, sv, m_in, m_out)
            else:
                sv, e = _sigma_step_ensemble(us, sv, m_in, m_out,
                                             approx=approx, with_err=True)
                err_b = err_b + e
    ks = ks_rev[::-1]
    if single:
        ks, bound = [k[0] for k in ks], bound[0]
    return (ks, bound) if with_bound else ks


def _update_matrices_opb(params: Params, phi_in: torch.Tensor,
                         phi_out: torch.Tensor, widths: Sequence[int], eta,
                         *, impl: str = "xla",
                         weights: Optional[torch.Tensor] = None) -> Params:
    """The ``engine="local_opb"`` baseline: vector A chain, OPERATOR-space
    B chain. B is peeled as a 2**n x 2**n operator with
    ``apply_unitary_local`` and each perceptron's trace is its own
    av^H B_j product through ``bmm`` (zgemm under impl="pallas", the
    conjugated av a lazy view the kernel's dispatch materialises).
    Shapes as ``update_matrices`` (node axis optional)."""
    single, params, phi_in, phi_out, weights = _node_axis(
        params, phi_in, phi_out, weights)
    vs = feedforward_ensemble(params, phi_in, widths)
    sigma = ql.pure_density(phi_out)  # sigma^L, updated on the way down
    if weights is None:
        denom = phi_in.shape[-2]
    else:
        w = weights.to(ql.real_dtype(sigma.dtype))
        sigma = sigma * w[..., None, None].to(sigma.dtype)
        denom = torch.clamp(torch.sum(w, dim=-1), min=1e-12)[:, None, None]

    ks_rev: Params = []
    for l in range(len(widths) - 1, 0, -1):
        us = params[l - 1]
        m_in, m_out = widths[l - 1], widths[l]
        n = m_in + m_out
        d_in, d_out = ql.dim(m_in), ql.dim(m_out)
        # B_m = I_in ⊗ sigma^l; B_j = U_{j+1}^H ... U_m^H B_m U_m ... U_{j+1}
        eye_in = torch.eye(d_in, dtype=sigma.dtype, device=sigma.device)
        b = torch.einsum("ab,...cd->...acbd", eye_in, sigma)
        b = b.reshape(sigma.shape[:-2] + (d_in * d_out, d_in * d_out))
        bs = [b]  # bs[0] is B_{m_out}
        for jj in range(m_out - 1, 0, -1):
            b = ql.apply_unitary_local(b, ql.dagger(_u(us, jj)),
                                       _acting(m_in, jj), n)
            bs.append(b)
        bs = bs[::-1]  # bs[j-1] is B_j

        av = _append_ancilla(vs[l - 1], m_out)  # (P, X, E, 2**n)
        layer_ks = []
        for j in range(m_out):
            av = ql.apply_unitary_vec(av, _u(us, j), _acting(m_in, j), n)
            avb = bmm(av.conj(), bs[j], impl=impl)  # av^H B_j
            t = ql.ensemble_trace_product(av, avb, _acting(m_in, j), n,
                                          batch_dims=1)
            layer_ks.append((eta * (2.0 ** m_in) * 1j / denom)
                            * (t - ql.dagger(t)))
        ks_rev.append(torch.stack(layer_ks, 1))

        # sigma^{l-1} = (I ⊗ <0..0|) U_1^H B_1 U_1 (I ⊗ |0..0>): the
        # backward pass folded into the B chain
        if l > 1:
            b0 = ql.apply_unitary_local(bs[0], ql.dagger(_u(us, 0)),
                                        _acting(m_in, 0), n)
            t4 = b0.reshape(b0.shape[:-2] + (d_in, d_out, d_in, d_out))
            sigma = t4[..., :, 0, :, 0]
    ks = ks_rev[::-1]
    return [k[0] for k in ks] if single else ks


def _dim_groups(arrs: Sequence[torch.Tensor]):
    """Group per-layer stacks (..., m_l, d, d) by identical (leading
    batch, d); yields (indices, per-layer m sizes)."""
    groups = {}
    for i, a in enumerate(arrs):
        groups.setdefault((tuple(a.shape[:-3]), a.shape[-1]), []).append(i)
    for idxs in groups.values():
        yield idxs, [arrs[i].shape[-3] for i in idxs]


def _grouped_layer_map(fn, arrs: Sequence[torch.Tensor],
                       extras: Optional[Sequence] = None) -> list:
    """fn over per-layer stacks, concatenated across same-dim layers on
    the perceptron axis (-3): one call per dimension group."""
    out = [None] * len(arrs)
    for idxs, sizes in _dim_groups(arrs):
        if len(idxs) == 1:
            i = idxs[0]
            out[i] = fn(arrs[i], None if extras is None else extras[i])
            continue
        cat = torch.cat([arrs[i] for i in idxs], dim=-3)
        ecat = (None if extras is None
                else torch.cat([extras[i] for i in idxs], dim=-3))
        res = fn(cat, ecat)
        for i, piece in zip(idxs, torch.split(res, sizes, dim=-3)):
            out[i] = piece
    return out


def apply_updates(params: Params, ks: Params, eps, *, impl: str = "xla"
                  ) -> Params:
    """Temporary update step: U^{l,j} <- e^{i eps K_j^l} U^{l,j}."""
    return _grouped_layer_map(
        lambda k, us: bmm(ql.expm_herm(k, eps), us, impl=impl), ks,
        extras=params)


def eigh_updates(ks: Params) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-layer eigh factors (lam, v) of the stacked update matrices,
    one batched eigh per dimension group; they serve every exponential
    of the same K within a round."""
    factored = [None] * len(ks)
    for idxs, sizes in _dim_groups(ks):
        if len(idxs) == 1:
            factored[idxs[0]] = ql.eigh_herm(ks[idxs[0]])
            continue
        lam, v = ql.eigh_herm(torch.cat([ks[i] for i in idxs], dim=-3))
        for i, lp, vp in zip(idxs, torch.split(lam, sizes, dim=-2),
                             torch.split(v, sizes, dim=-3)):
            factored[i] = (lp, vp)
    return factored


def apply_updates_eigh(params: Params,
                       factors: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       eps, *, impl: str = "xla") -> Params:
    """``apply_updates`` from cached ``eigh_updates`` factors (no eigh)."""
    return [bmm(ql.expm_eigh(lam, v, eps), us, impl=impl)
            for (lam, v), us in zip(factors, params)]


def update_unitaries(ks: Params, scale) -> Params:
    """The unitaries a node uploads, U = e^{i scale K} per perceptron
    (one exponential per dimension group)."""
    return _grouped_layer_map(lambda k, _: ql.expm_herm(k, scale), ks)


def apply_unitary_updates(params: Params, updates: Params, *,
                          impl: str = "xla") -> Params:
    """Left-multiply stacked per-perceptron unitaries onto the params
    (one batched matmul per dimension group)."""
    return _grouped_layer_map(
        lambda u, p: bmm(u, p, impl=impl), updates, extras=params)


def outputs(params: Params, phi_in: torch.Tensor, widths: Sequence[int], *,
            impl: str = "xla") -> torch.Tensor:
    """rho^out for a batch of pure input states."""
    return density_from_ensemble(
        feedforward_ensemble(params, phi_in, widths, compress=True)[-1],
        impl=impl)


def cost_fidelity(params: Params, phi_in: torch.Tensor,
                  phi_out: torch.Tensor, widths: Sequence[int], *,
                  impl: str = "xla") -> torch.Tensor:
    """Eq. 3: mean fidelity <phi_out| rho_out |phi_out> over the batch."""
    rho_out = outputs(params, phi_in, widths, impl=impl)
    return torch.mean(batched_fidelity(phi_out, rho_out, impl=impl))


def cost_mse(params: Params, phi_in: torch.Tensor, phi_out: torch.Tensor,
             widths: Sequence[int], *, impl: str = "xla") -> torch.Tensor:
    """Eq. 10: mean squared (Frobenius) error over the batch."""
    rho_out = outputs(params, phi_in, widths, impl=impl)
    return torch.mean(batched_mse(phi_out, rho_out, impl=impl))


def local_step(params: Params, phi_in: torch.Tensor, phi_out: torch.Tensor,
               widths: Sequence[int], eta, eps, *, engine: str = "local",
               impl: str = "xla", rank_tol: float = 0.0,
               rank_cap: Optional[int] = None,
               ensemble_dtype: Optional[str] = None
               ) -> Tuple[Params, Params]:
    """One QuanFedNode temporary-update step. Returns (new_params, Ks)."""
    ks = update_matrices(params, phi_in, phi_out, widths, eta,
                         engine=engine, impl=impl, rank_tol=rank_tol,
                         rank_cap=rank_cap, ensemble_dtype=ensemble_dtype)
    return apply_updates(params, ks, eps, impl=impl), ks
