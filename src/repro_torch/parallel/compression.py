"""Gradient compression for bandwidth-limited data-parallel reduction (port
of ``repro.parallel.compression``).

Int8 block-quantised compression with error feedback: gradients are
quantised before a cross-host reduction, and the quantisation residual is
carried into the next step, so the compressed trajectory tracks the exact
one (Karimireddy et al. 2019).  The reference does not wire it into
``make_train_step``, and neither does the port: its mesh step reduces
each parameter's f32 gradient sum once a step, uncompressed.

    comp = Int8ErrorFeedback(block=256)
    carry = comp.init(grads_like)
    grads_q, carry = comp.compress(grads, carry)   # before the all-reduce

Gradients are any container of ``utils.tree`` (a tensor, a dict, a list).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_unflatten


class EFState(NamedTuple):
    residual: Any


@dataclasses.dataclass(frozen=True)
class Int8ErrorFeedback:
    block: int = 256

    def init(self, params) -> EFState:
        return EFState(residual=tree_unflatten(params, [
            torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_leaves(params)]))

    def _quant(self, g):
        flat = g.reshape(-1)
        pad = (-flat.shape[0]) % self.block
        flat = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, self.block)
        scale = torch.amax(torch.abs(flat), dim=1, keepdim=True) / 127.0
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
        return q, scale

    def _dequant(self, q, scale, shape):
        flat = (q.to(torch.float32) * scale).reshape(-1)
        return flat[:int(torch.Size(shape).numel())].reshape(shape)

    def compress(self, grads, state: EFState):
        """Returns (dequantised grads after the round trip, new residuals).

        The dequantised value is what the all-reduce effectively transmits;
        the int8 payload is 1/4 of f32 (+1/block for the scales)."""
        out, res = [], []
        for g, r in zip(tree_leaves(grads), tree_leaves(state.residual)):
            g32 = g.to(torch.float32) + r
            q, scale = self._quant(g32)
            deq = self._dequant(q, scale, g.shape)
            out.append(deq.to(g.dtype))
            res.append(g32 - deq)
        return (tree_unflatten(grads, out),
                EFState(residual=tree_unflatten(state.residual, res)))

    def wire_volume_ratio(self) -> float:
        """Bytes on the wire vs an f32 all-reduce."""
        return (1.0 + 4.0 / self.block) / 4.0
