"""SSD through the chunk kernel (port of ``repro.kernels.ssd.ops``): the
kernel's per-chunk work, then the short inter-chunk state recurrence in
torch ops, as the reference keeps it in jnp.  Under autograd the chunk step
is the kernels' Function (``kernel.ssd_chunk_step``: its backward is the
SSD backward kernel) and the recurrence differentiates as torch ops."""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_chunk_step


def ssd_chunked_kernel(x, dt, a, b, c, d_skip, chunk: int = 128):
    """Same contract as ``models.ssm.ssd_chunked``: x (B,S,H,P), dt (B,S,H)
    f32, a (H,) f32, b/c (B,S,G,N) -> y (B,S,H,P) in x's dtype.  A sequence
    that is not a multiple of ``chunk`` raises.  Differentiable in every
    input."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g
    nc = s // chunk
    y_intra, states, cum = ssd_chunk_step(x, dt, a, b, c, chunk=chunk)

    # inter-chunk state recurrence (short, sequential).  The chunks are
    # taken apart once (unbind) and put together once (stack): under
    # autograd a slice read or written per chunk would make the backward
    # move a whole (B,NC,H,N,P) tensor per chunk
    decays = torch.exp(cum[:, :, -1, :])[..., None, None].unbind(1)
    run = torch.zeros_like(states[:, 0])
    prevs = []
    for st_i, dec_i in zip(states.unbind(1), decays):
        prevs.append(run)
        run = torch.addcmul(st_i, dec_i, run)
    prev = torch.stack(prevs, 1)

    cg = c.to(states.dtype).reshape(bs, nc, chunk, g, n)
    y_inter = torch.einsum("bclgn,bcgrnp->bclgrp", cg,
                           prev.view(bs, nc, g, rep, n, p))
    y_inter = y_inter.reshape(bs, nc, chunk, h, p) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bs, s, h, p).to(x.dtype)
    return y + d_skip[None, None, :, None].to(x.dtype) * x
