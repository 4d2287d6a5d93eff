"""Plain PyTorch versions of K1 and K2, and the closed-form mirror of the
kernels' hand-derived derivatives.

``atom_pass_plain`` / ``force_pass_plain`` have the kernels' signatures and
outputs.  Their derivatives come from autograd over the ported descriptor
(``finalize`` + ``mlp_energy``) and over a port of the reference's
``_pair_contract`` - exactly as the reference kernels take ``jax.vjp`` and
``jax.grad`` - so these oracles share none of the kernels' hand-derived
math.  The CPU path of the kernel wrappers calls them, the tests hold the
port against the JAX package through them, and ``chip_smoke.py`` compares
the CUDA kernels with them on the card.

``atom_pass_closed`` / ``force_pass_closed`` write the formulas the ``.cu``
files implement (the hand-derived K1 adjoint and K2 pair derivatives) once,
vectorized, so a CPU test can check them against autograd before any card
time is spent.  Nothing on the main path calls them.

Both plain versions walk the atoms in row blocks of ``PLAIN_ROWS`` so their
autograd intermediates stay bounded at production sizes, and take the
kernels' replica batches (a leading R on dr, si, sj, abar and the outputs;
one shared table, or a leading R on the table too) one replica at a
time.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.descriptor import (_LEGENDRE, _MONO, NEPSpinSpec,
                                         _monomials, _radial_g, accumulate,
                                         chebyshev_basis, finalize,
                                         init_accumulators)
from repro_torch.core.potential import NEPSpinParams, mlp_energy
from repro_torch.kernels.nep.layout import acc_keys, pack_abar, unpack_abar

PLAIN_ROWS = 2048


def _eps_for(dtype) -> float:
    """The kernels' distance regulariser (the reference's ``_eps_for``)."""
    return 1e-12 if dtype == torch.float32 else 1e-30


def _dist(dr: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(dr * dr, dim=-1) + _eps_for(dr.dtype))


def _grad_or_zero(out, inputs):
    grads = torch.autograd.grad(out, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, inputs)]


def _row_blocks(n: int):
    for lo in range(0, n, PLAIN_ROWS):
        yield slice(lo, min(lo + PLAIN_ROWS, n))


# ---------------------------------------------------------------------------
# K1: descriptor + ANN + adjoint accumulators
# ---------------------------------------------------------------------------

def _atom_block(spec, params, dr, mask, ti, tj, si, sj):
    keys = acc_keys(spec)
    acc0 = init_accumulators(spec, dr.shape[:-2], dr.dtype, dr.device)
    acc = accumulate(spec, params.desc_params(), acc0, dr, _dist(dr), mask,
                     ti, tj, si, sj)
    leaves = [acc[k].detach().requires_grad_(True) for k in keys]
    s = si.detach().requires_grad_(True)
    with torch.enable_grad():
        e = mlp_energy(params, finalize(spec, dict(zip(keys, leaves)), s), ti)
        grads = _grad_or_zero(e.sum(), leaves + [s])
    return e.detach(), -grads[-1], pack_abar(spec, dict(zip(keys, grads)))


def _per_replica(flat, dr, *args):
    """``flat`` on each replica of a batch (dr (R, N, M, 3)), stacked;
    ``args`` are ``(batched, tensor)`` pairs: a batched tensor is taken per
    replica, a shared one whole."""
    outs = [flat(dr[r], *(x[r] if batched else x for batched, x in args))
            for r in range(dr.shape[0])]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def atom_pass_plain(spec: NEPSpinSpec, params: NEPSpinParams, dr, mask, ti,
                    tj, si, sj):
    """K1 by autograd: ``(e (N,), hdir (N,3), abar (N, A))`` with
    ``hdir = -dE_i/dS_i`` at fixed accumulators and ``abar`` the packed
    dE_i/dA_i (:mod:`repro_torch.kernels.nep.layout`); replica batches as
    the kernel takes them."""
    if dr.dim() == 4:
        own = mask.dim() == 3         # per-replica tables
        return _per_replica(
            lambda d, *a: atom_pass_plain(spec, params, d, *a), dr,
            (own, mask), (own, ti), (own, tj), (True, si), (True, sj))
    outs = [_atom_block(spec, params, dr[b], mask[b], ti[b], tj[b], si[b],
                        sj[b]) for b in _row_blocks(dr.shape[0])]
    return tuple(torch.cat(parts) for parts in zip(*outs))


# ---------------------------------------------------------------------------
# K2: fused force + torque (pair-symmetric, no reverse scatter)
# ---------------------------------------------------------------------------

def pair_contract(spec: NEPSpinSpec, dp: dict, dr, mask, ti, tj, si, sj,
                  abar_i: dict, abar_j: dict) -> torch.Tensor:
    """Port of the reference's ``_pair_contract``:

        t = sum_ij [ <Abar_i, a(dr_ij, S_i, S_j)> + <Abar_j, a(-dr_ij, S_j, S_i)> ]

    with one basis shared by both orientations: the angular monomials take
    ``(-1)^p`` in the j-half, ``sp_w`` flips sign, and S_i enters the j-half
    as the neighbor spin.  ``abar_i`` leaves are (B, ...), ``abar_j``
    leaves are gathered (B, M, ...).
    """
    m = mask.to(dr.dtype)
    dist = _dist(dr)
    fk = chebyshev_basis(dist, spec.cutoff, spec.basis_size) * m[..., None]
    rhat = dr / dist[..., None]

    def both(coeffs):   # (c[ti, tj], c[tj, ti]) carriers
        return (_radial_g(coeffs, fk, ti, tj),
                _radial_g(coeffs.transpose(0, 1), fk, ti, tj))

    g1r, g2r = both(dp["c_rad"])
    tot = (torch.einsum("amn,an->", g1r, abar_i["rad"])
           + torch.einsum("amn,amn->", g2r, abar_j["rad"]))
    g1a, g2a = both(dp["c_ang"])
    for p in range(spec.l_max + 1):
        mono = _monomials(rhat, p)
        sign = -1.0 if p % 2 else 1.0
        tot = tot + torch.einsum("amj,amc,ajc->", g1a, mono,
                                 abar_i[f"ang{p}"])
        tot = tot + sign * torch.einsum("amj,amc,amjc->", g2a, mono,
                                        abar_j[f"ang{p}"])
    if spec.spin:
        g1s, g2s = both(dp["c_spin"])
        si_b = si[:, None, :].expand_as(sj)
        dot_ss = torch.sum(si_b * sj, dim=-1)
        dmi = torch.sum(torch.linalg.cross(si_b, sj, dim=-1) * rhat, dim=-1)
        pd = torch.sum(si_b * rhat, dim=-1) * torch.sum(sj * rhat, dim=-1)
        for cpl, key in ((dot_ss, "sp_dot"), (dmi, "sp_dmi"), (pd, "sp_pd")):
            tot = tot + torch.einsum("amj,am,aj->", g1s, cpl, abar_i[key])
            tot = tot + torch.einsum("amj,am,amj->", g2s, cpl, abar_j[key])
        tot = tot + torch.einsum("amj,amd,ajd->", g1s, sj, abar_i["sp_v"])
        tot = tot + torch.einsum("amj,ad,amjd->", g2s, si, abar_j["sp_v"])
        tot = tot + torch.einsum("amj,amd,ajd->", g1s, rhat, abar_i["sp_w"])
        tot = tot - torch.einsum("amj,amd,amjd->", g2s, rhat, abar_j["sp_w"])
    return tot


def force_pass_plain(spec: NEPSpinSpec, params: NEPSpinParams, dr, mask, idx,
                     ti, tj, si, sj, abar):
    """K2 by autograd: ``(F (N,3), h2 (N,3))`` with
    ``F_i = sum_m dt/d(dr_im)`` and ``h2 = -dt/dS_i``; ``abar`` is K1's
    packed (N, A) buffer, gathered here through ``idx``.  The S_j gradient
    belongs to atom j's own row and is discarded.  Replica batches (shared
    or per-replica tables, ``abar`` (R, n_src, A)) as the kernel takes
    them."""
    if dr.dim() == 4:
        own = mask.dim() == 3         # per-replica tables
        return _per_replica(
            lambda d, *a: force_pass_plain(spec, params, d, *a), dr,
            (own, mask), (own, idx), (own, ti), (own, tj),
            (True, si), (True, sj), (True, abar))
    dp = params.desc_params()
    fs, hs = [], []
    for b in _row_blocks(dr.shape[0]):
        abar_i = unpack_abar(spec, abar[b])
        abar_j = unpack_abar(spec, abar[idx[b].long()])
        d = dr[b].detach().requires_grad_(True)
        s = si[b].detach().requires_grad_(True)
        with torch.enable_grad():
            t = pair_contract(spec, dp, d, mask[b], ti[b], tj[b], s, sj[b],
                              abar_i, abar_j)
            g_dr, g_si = _grad_or_zero(t, [d, s])
        fs.append(g_dr.sum(dim=1))
        hs.append(-g_si)
    return torch.cat(fs), torch.cat(hs)


# ---------------------------------------------------------------------------
# Closed-form mirror of the kernels' hand-derived derivatives
# ---------------------------------------------------------------------------

def _mono_tables(l_max: int):
    """Per degree p: exponents (C, 3) and weights (C,) as python lists."""
    return {p: ([e for e, _ in _MONO[p]], [w for _, w in _MONO[p]])
            for p in range(l_max + 1)}


def _mono_grad(rhat: torch.Tensor, exps) -> torch.Tensor:
    """d mono_c / d rhat for each monomial c: (..., C, 3)."""
    x, y, z = rhat[..., 0], rhat[..., 1], rhat[..., 2]

    def pw(v, e):
        return v ** e if e > 0 else torch.ones_like(v)

    cols = []
    for ex, ey, ez in exps:
        gx = ex * pw(x, ex - 1) * pw(y, ey) * pw(z, ez) if ex else 0 * x
        gy = ey * pw(x, ex) * pw(y, ey - 1) * pw(z, ez) if ey else 0 * x
        gz = ez * pw(x, ex) * pw(y, ey) * pw(z, ez - 1) if ez else 0 * x
        cols.append(torch.stack([gx, gy, gz], dim=-1))
    return torch.stack(cols, dim=-2)


def _select_mlp(params: NEPSpinParams, ti: torch.Tensor):
    t = ti.long()
    return params.w1[t], params.b1[t], params.w2[t]


def atom_pass_closed(spec: NEPSpinSpec, params: NEPSpinParams, dr, mask, ti,
                     tj, si, sj):
    """K1 with the hand-derived backward of tanh-MLP <- q/q_scale <-
    finalize that ``nep_atom_pass.cu`` implements."""
    acc0 = init_accumulators(spec, dr.shape[:-2], dr.dtype, dr.device)
    acc = accumulate(spec, params.desc_params(), acc0, dr, _dist(dr), mask,
                     ti, tj, si, sj)
    q = finalize(spec, acc, si)
    w1, b1, w2 = _select_mlp(params, ti)           # (N,D,H), (N,H), (N,H)
    qn = q / params.q_scale
    h = torch.tanh(torch.einsum("nd,ndh->nh", qn, w1) + b1)
    e = mlp_energy(params, q, ti)
    dz = w2 * (1.0 - h * h)
    dq = torch.einsum("ndh,nh->nd", w1, dz) / params.q_scale

    ab = {"rad": dq[:, :spec.n_rad]}
    o = spec.n_rad
    dql = {l: dq[:, o + (l - 1) * spec.n_ang: o + l * spec.n_ang]
           for l in range(1, spec.l_max + 1)}
    tables = _mono_tables(spec.l_max)
    for p in range(spec.l_max + 1):
        dmp = sum(_LEGENDRE[l][p] * dql[l] for l in range(1, spec.l_max + 1)
                  if p in _LEGENDRE[l])
        w = torch.tensor(tables[p][1], dtype=dr.dtype, device=dr.device)
        if isinstance(dmp, int):       # p appears in no feature
            dmp = torch.zeros_like(acc[f"ang{p}"][..., 0])
        ab[f"ang{p}"] = dmp[..., None] * 2.0 * w * acc[f"ang{p}"]
    dsi = torch.zeros_like(si)
    if spec.spin:
        o = spec.n_rad + spec.n_ang * spec.l_max
        ns = spec.n_spin
        dq_ons = dq[:, o:o + spec.n_onsite]
        o += spec.n_onsite
        ab["sp_dot"] = dq[:, o:o + ns]
        ab["sp_dmi"] = dq[:, o + ns:o + 2 * ns]
        ab["sp_pd"] = dq[:, o + 2 * ns:o + 3 * ns]
        dq_vv = dq[:, o + 3 * ns:o + 4 * ns, None]
        dq_vs = dq[:, o + 4 * ns:o + 5 * ns, None]
        dq_wv = dq[:, o + 5 * ns:o + 6 * ns, None]
        v, w = acc["sp_v"], acc["sp_w"]
        ab["sp_v"] = 2.0 * v * dq_vv + si[:, None, :] * dq_vs + w * dq_wv
        ab["sp_w"] = v * dq_wv
        smag = torch.sqrt(torch.sum(si * si, dim=-1) + 1e-30)
        dsmag = sum((k + 1) * smag ** k * dq_ons[:, k]
                    for k in range(spec.n_onsite))
        dsi = dsmag[:, None] * si / smag[:, None] + torch.sum(v * dq_vs, dim=1)
    return e, -dsi, pack_abar(spec, ab)


def force_pass_closed(spec: NEPSpinSpec, params: NEPSpinParams, dr, mask,
                      idx, ti, tj, si, sj, abar):
    """K2 with the hand-derived pair derivatives that ``nep_force_pass.cu``
    implements: for each pair, dt/dr through the Chebyshev basis and cutoff,
    plus the rhat-gradient P projected by (I - rhat rhat^T)/r, and dt/dS_i
    from the spin couplings."""
    rc = spec.cutoff
    r = _dist(dr)
    rhat = dr / r[..., None]
    m = (mask & (r < rc)).to(dr.dtype)
    xc = torch.clamp(r / rc, 0.0, 1.0)
    x = 2.0 * (xc - 1.0) ** 2 - 1.0
    dx = 4.0 * (xc - 1.0) / rc
    fc = 0.5 * (1.0 + torch.cos(math.pi * xc))
    dfc = -0.5 * math.pi / rc * torch.sin(math.pi * xc)
    ts, dts = [torch.ones_like(x), x], [torch.zeros_like(x), torch.ones_like(x)]
    for _ in range(2, spec.basis_size):
        ts.append(2.0 * x * ts[-1] - ts[-2])
        dts.append(2.0 * ts[-2] + 2.0 * x * dts[-1] - dts[-2])
    tk = torch.stack(ts[:spec.basis_size], dim=-1)
    dtk = torch.stack(dts[:spec.basis_size], dim=-1)
    f = 0.5 * (tk + 1.0) * fc[..., None] * m[..., None]
    df = (0.5 * dtk * (dx * fc)[..., None]
          + 0.5 * (tk + 1.0) * dfc[..., None]) * m[..., None]

    ai = unpack_abar(spec, abar)
    aj = unpack_abar(spec, abar[idx.long()])
    t_i, t_j = ti.long()[:, None], tj.long()

    def coeffs(c):       # per-pair c[ti, tj] and c[tj, ti]: (N, M, n, K)
        return c[t_i, t_j], c[t_j, t_i]

    c1, c2 = coeffs(params.c_rad)
    coef = (torch.einsum("nmak,na->nmk", c1, ai["rad"])
            + torch.einsum("nmak,nma->nmk", c2, aj["rad"]))

    c1, c2 = coeffs(params.c_ang)
    g1a = torch.einsum("nmak,nmk->nma", c1, f)
    g2a = torch.einsum("nmak,nmk->nma", c2, f)
    p_vec = torch.zeros_like(dr)
    yi = torch.zeros_like(g1a)
    yj = torch.zeros_like(g1a)
    tables = _mono_tables(spec.l_max)
    for p in range(spec.l_max + 1):
        sign = -1.0 if p % 2 else 1.0
        mono = _monomials(rhat, p)                      # (N, M, C)
        gmono = _mono_grad(rhat, tables[p][0])          # (N, M, C, 3)
        a_i, a_j = ai[f"ang{p}"], aj[f"ang{p}"]         # (N,a,C), (N,M,a,C)
        yi = yi + torch.einsum("nmc,nac->nma", mono, a_i)
        yj = yj + sign * torch.einsum("nmc,nmac->nma", mono, a_j)
        bvec = (torch.einsum("nma,nac->nmc", g1a, a_i)
                + sign * torch.einsum("nma,nmac->nmc", g2a, a_j))
        p_vec = p_vec + torch.einsum("nmc,nmcd->nmd", bvec, gmono)
    coef = (coef + torch.einsum("nmak,nma->nmk", c1, yi)
            + torch.einsum("nmak,nma->nmk", c2, yj))

    dsi = torch.zeros_like(dr)
    if spec.spin:
        c1, c2 = coeffs(params.c_spin)
        g1s = torch.einsum("nmak,nmk->nma", c1, f)
        g2s = torch.einsum("nmak,nmk->nma", c2, f)
        si_b = si[:, None, :].expand_as(sj)
        dot = torch.sum(si_b * sj, dim=-1)
        cross = torch.linalg.cross(si_b, sj, dim=-1)
        dmi = torch.sum(cross * rhat, dim=-1)
        sir = torch.sum(si_b * rhat, dim=-1)
        sjr = torch.sum(sj * rhat, dim=-1)
        pd = sir * sjr
        zi = (dot[..., None] * ai["sp_dot"][:, None]
              + dmi[..., None] * ai["sp_dmi"][:, None]
              + pd[..., None] * ai["sp_pd"][:, None]
              + torch.einsum("nmd,nad->nma", sj, ai["sp_v"])
              + torch.einsum("nmd,nad->nma", rhat, ai["sp_w"]))
        zj = (dot[..., None] * aj["sp_dot"] + dmi[..., None] * aj["sp_dmi"]
              + pd[..., None] * aj["sp_pd"]
              + torch.einsum("nd,nmad->nma", si, aj["sp_v"])
              - torch.einsum("nmd,nmad->nma", rhat, aj["sp_w"]))
        coef = (coef + torch.einsum("nmak,nma->nmk", c1, zi)
                + torch.einsum("nmak,nma->nmk", c2, zj))

        def sgs(key):   # sum_n g1s A_i[n] + g2s A_j[n]
            return (torch.einsum("nma,na->nm", g1s, ai[key])
                    + torch.einsum("nma,nma->nm", g2s, aj[key]))

        s_dot, s_dmi, s_pd = sgs("sp_dot"), sgs("sp_dmi"), sgs("sp_pd")
        w_vec = (torch.einsum("nma,nad->nmd", g1s, ai["sp_w"])
                 - torch.einsum("nma,nmad->nmd", g2s, aj["sp_w"]))
        v_j = torch.einsum("nma,nmad->nmd", g2s, aj["sp_v"])
        p_vec = (p_vec + s_dmi[..., None] * cross
                 + s_pd[..., None] * (si_b * sjr[..., None]
                                      + sj * sir[..., None])
                 + w_vec)
        dsi = (s_dot[..., None] * sj
               + s_dmi[..., None] * torch.linalg.cross(sj, rhat, dim=-1)
               + (s_pd * sjr)[..., None] * rhat + v_j)
    dtdr = torch.sum(df * coef, dim=-1)
    proj = p_vec - rhat * torch.sum(rhat * p_vec, dim=-1, keepdim=True)
    fpair = (rhat * dtdr[..., None] + proj / r[..., None]) * m[..., None]
    return fpair.sum(dim=1), -(dsi * m[..., None]).sum(dim=1)
