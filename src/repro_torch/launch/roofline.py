"""Three-term roofline of the dry-run records and the NEP kernels' bounds,
on an NVIDIA H100 SXM (port of ``repro.launch.roofline``).

Card constants (NVIDIA's H100 SXM data sheet, dense rates, at the full
700 W power limit):

  compute : 989 TFLOP/s bf16 / fp16 on the tensor cores; 67 TFLOP/s f32 and
            34 TFLOP/s f64 outside them (the MD work: NEP-SPIN runs in f32
            or f64 on the CUDA cores)
  HBM     : 3.35 TB/s
  links   : NVLink, 450 GB/s each way to the other cards of an 8-card host;
            between hosts, one 400 Gb/s NDR InfiniBand port per card (the
            DGX H100 layout), 50 GB/s each way

The dry-run records are PER-RANK quantities (the counted step is one rank's
program), so the terms are

  compute_term    = flops_rank / peak(dtype)
  memory_term     = bytes_rank / HBM
  collective_term = collective_bytes_rank / link

in seconds a step, the link being NVLink for a mesh of at most 8 cards and
the inter-host port beyond (a 16x16 mesh's halo partners sit on other
hosts); the dominant term is the bottleneck.  ``model_flops`` is the
analytic useful work (6ND training, 2ND inference for an LM; none for the
MD cells, whose analytic model is :func:`nep_analytic`).

The NEP half: :func:`nep_analytic` is the reference's per-pair FLOP and
byte model with this card's peaks; :func:`atom_pass_work` /
:func:`force_pass_work` count one K1 / K2 call's work over its pairs inside
the cutoff and the bytes it must move (each input read once, each output
written once), :func:`bound` turns them into the least time the card could
take, and :func:`nep_measured` times the kernels with CUDA events at a
geometry (:func:`nep_stages` sets their calls up).  The flash-attention
half: :func:`fa_pairs` counts the (query, key) pairs the masks keep,
:func:`fa_fwd_work` / :func:`fa_bwd_work` one forward / backward call's
bytes and product FLOPs; :func:`ssd_fwd_work` / :func:`ssd_bwd_work` the
same for the SSD chunk step.  ``chip_smoke.py`` reads every kernel bound
from here.
"""
from __future__ import annotations

HBM_BW = 3.35e12                # bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12,
              "float64": 34e12}
NVLINK_BW = 450e9               # bytes/s each way, within an 8-card host
INTERHOST_BW = 400e9 / 8        # bytes/s each way: one 400 Gb/s NDR port
HOST_CARDS = 8


def peak_flops(dtype) -> float:
    """The card's peak for ``dtype`` (a torch dtype or its name)."""
    return PEAK_FLOPS[str(dtype).split(".")[-1]]


def link(n_cards: int) -> tuple[str, float]:
    """(name, bytes/s each way) of the link a mesh of ``n_cards`` is bound
    by."""
    if n_cards <= HOST_CARDS:
        return "nvlink", NVLINK_BW
    return "infiniband-ndr", INTERHOST_BW


def model_flops(arch: str, kind: str, tokens: int) -> float:
    """Analytic useful FLOPs of the whole step (global), for every arch of
    the registry; an unknown one raises (``configs.get``)."""
    if arch == "fege-spinlattice":
        return 0.0  # per-atom descriptor cost: see nep_analytic()
    from repro_torch import configs
    n = configs.get(arch).n_active_params()
    return (6.0 if kind == "train" else 2.0) * n * tokens


def terms(rec: dict) -> dict:
    n_dev = rec["devices"]
    meta = rec.get("meta", {})
    peak = peak_flops(meta.get("dtype", "bfloat16"))
    link_name, link_bw = link(n_dev)
    flops_dev = rec["flops_total"]          # per rank
    bytes_dev = rec["bytes_total"]
    coll_dev = sum(v["bytes"] for v in rec["collectives"].values())
    compute_t = flops_dev / peak
    memory_t = bytes_dev / HBM_BW
    coll_t = coll_dev / link_bw
    terms_ = {"compute": compute_t, "memory": memory_t,
              "collective": coll_t}
    bottleneck = max(terms_, key=terms_.get)
    mf = model_flops(rec["arch"], meta.get("kind", "train"),
                     meta.get("tokens", 0))
    mf_dev = mf / n_dev if n_dev else 0.0
    step = max(terms_.values())
    return {
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": coll_t,
        "collective_bytes": coll_dev,
        "collective_link": link_name,
        "peak_flops": peak,
        "bottleneck": bottleneck,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf_dev / flops_dev) if flops_dev else None,
        "step_time_s": step,
        "roofline_fraction_compute": compute_t / step if step else None,
    }


# ---------------------------------------------------------------------------
# NEP-SPIN kernels (arch "fege-spinlattice")
# ---------------------------------------------------------------------------

def nep_abar_row(spec) -> int:
    """Scalars per atom in the adjoint set Abar (the q_Fp halo payload row
    and the row K2 reads per neighbour)."""
    from repro_torch.core.descriptor import _MONO
    n = spec.n_rad
    n += sum(spec.n_ang * len(_MONO[p]) for p in range(spec.l_max + 1))
    if spec.spin:
        n += 3 * spec.n_spin        # sp_dot, sp_dmi, sp_pd
        n += 2 * spec.n_spin * 3    # sp_v, sp_w vectors
    return n


def nep_pair_flops(spec) -> float:
    """Analytic FLOPs of ONE pair's descriptor accumulation: Chebyshev
    recurrence + the T^2 predicated basis->channel contractions + angular
    monomial outer products + spin couplings."""
    from repro_torch.core.descriptor import _MONO
    k = spec.basis_size
    t2 = spec.n_types ** 2
    fl = 3.0 * k + 10.0                           # recurrence + cutoff fn
    n_ch = spec.n_rad + spec.n_ang + (spec.n_spin if spec.spin else 0)
    fl += 2.0 * t2 * k * n_ch                     # dense f_k -> g_n
    for p in range(spec.l_max + 1):
        c = len(_MONO[p])
        fl += 4.0 * c + 2.0 * spec.n_ang * c      # monomials + accumulation
    if spec.spin:
        fl += 30.0 + 18.0 * spec.n_spin           # couplings + contractions
    return fl


# reverse-mode multipliers: K1 runs accumulate forward + its adjoint (~2x);
# K2 evaluates both pair orientations off one shared basis (~1.5x a single
# accumulate) and differentiates that (~3x its primal)
K1_MULT = 3.0
K2_MULT = 4.5


def nep_analytic(spec, n_atoms: int, m: int, itemsize: int = 4) -> dict:
    """Analytic FLOPs/bytes of one force call at (n_atoms, m_cap), every
    table slot counted: the neighbour blocks (read by K1 and K2) and the
    neighbour adjoint rows (every pair reads a full Abar row)."""
    pairs = float(n_atoms) * m
    c_pair = nep_pair_flops(spec)
    mlp = 6.0 * (spec.n_desc * spec.hidden + spec.hidden)    # fwd + vjp
    k1 = pairs * c_pair * K1_MULT + n_atoms * mlp
    k2 = pairs * c_pair * K2_MULT
    row = nep_abar_row(spec)
    gather_bytes = (n_atoms * m * row + n_atoms * row) * itemsize
    block_bytes = 2.0 * pairs * 8 * itemsize     # dr(3)+sj(3)+tj+mask, x2
    flops = k1 + k2
    hbm = gather_bytes + block_bytes
    dtype = {2: "bfloat16", 4: "float32", 8: "float64"}[itemsize]
    return {
        "flops": flops, "k1_flops": k1, "k2_flops": k2,
        "pair_flops": c_pair, "abar_row": row,
        "gather_bytes_abar_j": gather_bytes, "hbm_bytes": hbm,
        "arithmetic_intensity": flops / hbm if hbm else None,
        "compute_s": flops / peak_flops(dtype), "memory_s": hbm / HBM_BW,
    }


def flops_atom_pass(spec, n_atoms, n_pairs) -> float:
    """K1: per pair the distance, basis, carriers and accumulation; per atom
    finalize, the MLP forward and backward, and the adjoints."""
    k, nm = spec.basis_size, (spec.l_max + 1) * (spec.l_max + 2) * (
        spec.l_max + 3) // 6
    d = spec.n_desc
    pair = (18 + 6 * k + 2 * spec.n_rad * k + 12 + 2 * nm
            + spec.n_ang * (2 * k + 2 * nm))
    atom = 3 * spec.n_ang * nm + 4 * d * spec.hidden + 6 * spec.hidden
    if spec.spin:
        pair += 30 + spec.n_spin * (2 * k + 18)
        atom += 20 * spec.n_spin + 4 * spec.n_onsite
    return float(pair * n_pairs + atom * n_atoms)


def flops_force_pass(spec, n_atoms, n_pairs) -> float:
    """K2: per pair the distance, basis and its derivative, both halves'
    coefficient sums, the angular and spin contractions, the rhat gradient
    and the projection onto dr."""
    k, nm = spec.basis_size, (spec.l_max + 1) * (spec.l_max + 2) * (
        spec.l_max + 3) // 6
    pair = (21 + 12 * k + 4 * spec.n_rad * k + 12 + 2 * nm
            + spec.n_ang * (8 * k + 9 * nm) + 15 * nm + 2 * k + 24)
    if spec.spin:
        pair += 75 + spec.n_spin * (8 * k + 47)
    return float(pair * n_pairs + 6 * n_atoms)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fa_pairs(s: int, t: int, causal: bool, window: int) -> int:
    """(query, key) pairs FA's masks keep for one head: row i sees keys in
    [max(0, i - window + 1), min(t, i + 1)) (causal) or [.., t)."""
    import numpy as np
    i = np.arange(s, dtype=np.int64)
    hi = np.minimum(t, i + 1) if causal else np.full(s, t, np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def fa_fwd_work(q, k, v, *, causal: bool, window: int) -> tuple[int, float]:
    """(bytes, FLOPs) of one FA forward call: q, k, v read once, o written
    once; 2 (d + dv) flop of products a kept pair and head."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    pairs = b * h * fa_pairs(s, k.shape[1], causal, window)
    return (nbytes(q, k, v) + b * s * h * dv * q.element_size(),
            2.0 * pairs * (d + dv))


def fa_bwd_work(q, k, v, o, lse, do, *, causal: bool,
                window: int) -> tuple[int, float]:
    """(bytes, FLOPs) of one FA backward call: q, k, v, o, lse and dO read
    once, dq, dk and dv written once; the least products a kept pair and
    head needs, 2 (3d + 2dv) flop (S = Q K^T and dQ, dK at 2d each; dP =
    dO V^T and dV at 2dv each)."""
    b, s, h, d = q.shape
    dv = v.shape[-1]
    pairs = b * h * fa_pairs(s, k.shape[1], causal, window)
    return (nbytes(q, k, v, o, lse, do) + nbytes(q, k, v),
            2.0 * pairs * (3 * d + 2 * dv))


def ssd_fwd_work(x, dt, a, b, c, *, chunk: int) -> tuple[int, float]:
    """(bytes, FLOPs) of one SSD chunk-step forward call: x, dt, a, b and
    c read once, its f32 y_intra, states and cum written once; per
    (batch, chunk, head) the products over the causal triangle of T =
    L (L + 1) / 2 pairs: C B^T (T N) and W x (T P), and the chunk state
    (L N P), 2 flops each."""
    bs, s, h, p = x.shape
    n = b.shape[3]
    nc, L = s // chunk, chunk
    tri = L * (L + 1) // 2
    out = 4 * bs * nc * (L * h * p + h * n * p + L * h)
    return (nbytes(x, dt, a, b, c) + out,
            2.0 * bs * nc * h * (tri * n + tri * p + L * n * p))


def ssd_bwd_work(x, dt, a, b, c, cum, dy, dst, dcum, *,
                 chunk: int) -> tuple[int, float]:
    """(bytes, FLOPs) of one SSD chunk-step backward call: x, dt, a, b, c,
    cum and the three output gradients read once, dx, d(dt), da, db and dc
    written once at their inputs' widths (db and dc at the group's, which
    the work needs: the kernel's per-head partials are its own choice);
    per (batch, chunk, head) the least products, 2 flops each: over the
    causal triangle C B^T recomputed, dC and dB (T N each), dY X^T and
    W^T dY (T P each); over the chunk B dS and X dS^T (L N P each)."""
    bs, s, h, p = x.shape
    n = b.shape[3]
    nc, L = s // chunk, chunk
    tri = L * (L + 1) // 2
    return (nbytes(x, dt, a, b, c, cum, dy, dst, dcum) + nbytes(x, dt, a, b,
                                                                 c),
            2.0 * bs * nc * h * (3 * tri * n + 2 * tri * p + 2 * L * n * p))


def pairs_inside(dr, mask, cutoff: float) -> int:
    """Table pairs within the cutoff (the pairs the kernels work on)."""
    import torch
    r = torch.sqrt((dr * dr).sum(-1) + 1e-12)
    return int((mask & (r < cutoff)).sum())


def atom_pass_work(spec, params, dr, mask, ti, tj, si, sj, outputs,
                   n_pairs: int) -> tuple[int, float]:
    """(bytes, FLOPs) of one K1 call: its inputs and the weights read
    once, its outputs ``(e, hdir, abar)`` written once."""
    n_atoms = si.shape[-2]
    return (nbytes(dr, mask, ti, tj, si, sj, *outputs) + nbytes(*params),
            flops_atom_pass(spec, n_atoms, n_pairs))


def force_pass_work(spec, params, dr, mask, idx, ti, tj, si, sj, abar,
                    outputs, n_pairs: int) -> tuple[int, float]:
    """(bytes, FLOPs) of one K2 call: its inputs and the three carrier
    tables read once, ``(F, h2)`` written once."""
    n_atoms = si.shape[-2]
    return (nbytes(dr, mask, idx, ti, tj, si, sj, abar, *outputs)
            + nbytes(params.c_rad, params.c_ang, params.c_spin),
            flops_force_pass(spec, n_atoms, n_pairs))


def bound(n_bytes: float, flops: float, dtype) -> dict:
    """The least time the card could take: the larger of the bytes at the
    HBM rate and the operations at ``dtype``'s peak."""
    t_bytes = 1e3 * n_bytes / HBM_BW
    t_ops = 1e3 * flops / peak_flops(dtype)
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops, "bytes": int(n_bytes),
            "flops": float(flops)}


def time_ms(fn, reps: int, warmup: int) -> float:
    """CUDA-event ms of one ``fn()`` on the card, the mean of ``reps``
    calls after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def nep_stages(spec, params, nbh, spin, types) -> tuple[dict, dict, int]:
    """K1 and K2 at a geometry (``nbh`` a
    :class:`repro_torch.md.neighbor.Neighborhood` of this spin state):
    ``({name: call}, {name: (bytes, FLOPs)}, pairs inside the cutoff)``,
    each kernel called once here to size its outputs."""
    from repro_torch.kernels.nep.kernel import nep_atom_pass, nep_force_pass
    sj = spin[nbh.idx.long()]
    blocks = (nbh.dr, nbh.mask, types, nbh.tj, spin, sj)
    n_pairs = pairs_inside(nbh.dr, nbh.mask, spec.cutoff)
    k1 = nep_atom_pass(spec, params, *blocks)
    k2_args = (spec, params, nbh.dr, nbh.mask, nbh.idx, types, nbh.tj, spin,
               sj, k1[2])
    k2 = nep_force_pass(*k2_args)
    calls = {"nep_atom_pass": lambda: nep_atom_pass(spec, params, *blocks),
             "nep_force_pass": lambda: nep_force_pass(*k2_args)}
    work = {"nep_atom_pass": atom_pass_work(spec, params, *blocks, k1,
                                            n_pairs),
            "nep_force_pass": force_pass_work(spec, params, *k2_args[2:],
                                              k2, n_pairs)}
    return calls, work, n_pairs


def nep_measured(spec, params, nbh, spin, types, reps: int = 20,
                 warmup: int = 2) -> dict:
    """K1 and K2 on the card at a geometry (:func:`nep_stages`):
    CUDA-event ms of each (after ``warmup`` calls), the pairs inside the
    cutoff, each kernel's bound, its share of the bound and its achieved
    GFLOP/s and GB/s.  Raises on CPU tensors: host timings are not device
    numbers."""
    if spin.device.type != "cuda":
        raise ValueError("nep_measured times the kernels on the card; the "
                         f"tensors are on {spin.device}")
    calls, work, n_pairs = nep_stages(spec, params, nbh, spin, types)
    out = {"n_atoms": int(spin.shape[-2]), "m_cap": int(nbh.idx.shape[-1]),
           "n_pairs": n_pairs, "dtype": str(spin.dtype).split(".")[-1]}
    for name, (b, f) in work.items():
        ms = time_ms(calls[name], reps, warmup)
        bd = bound(b, f, spin.dtype)
        out[name] = {**bd, "ms": ms, "share_of_bound": bd["bound_ms"] / ms,
                     "gflop_per_s": f / ms / 1e6, "gb_per_s": b / ms / 1e6}
    return out


def nep_report(spec, params, nbh, spin, types, **kw) -> dict:
    """Measured-vs-analytic record at a geometry: ``analytic``
    (:func:`nep_analytic`, every table slot), ``measured``
    (:func:`nep_measured`), each kernel's share of its bound, and
    ``flops_ratio``: the work counted over the pairs inside the cutoff
    against the analytic model's."""
    meas = nep_measured(spec, params, nbh, spin, types, **kw)
    ana = nep_analytic(spec, meas["n_atoms"], meas["m_cap"],
                       itemsize=spin.element_size())
    counted = (meas["nep_atom_pass"]["flops"]
               + meas["nep_force_pass"]["flops"])
    return {"analytic": ana, "measured": meas,
            "share_of_bound": {k: meas[k]["share_of_bound"]
                               for k in ("nep_atom_pass", "nep_force_pass")},
            "flops_ratio": counted / ana["flops"] if ana["flops"] else None,
            "n_atoms": meas["n_atoms"]}
