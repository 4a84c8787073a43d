"""The depth student's FLOPs for `mfu.distill`: harness/trace.py's dense and
1-d convolution counts, plus the 2-d convolutions of the depth backbone and
the GRU cell's two products (its input kernels over x and its recurrent
kernels over h, `F.linear` calls that no nn.Linear hook sees).

Nothing here runs in an untraced run."""
from __future__ import annotations

import torch
from torch import nn

from benchmark.harness import trace as tr
from benchmark.harness import yardstick as ys


def conv2d_flops(batch: int, c_in: int, c_out: int, kh: int, kw: int, h_out: int, w_out: int,
                 groups: int = 1) -> int:
    """Multiply-adds of a 2-d convolution, counted as 2 FLOPs."""
    return 2 * batch * c_out * h_out * w_out * (c_in // groups) * kh * kw


def gru_cell_flops(rows: int, d_in: int, hidden: int) -> int:
    """The GRU cell's products: (rows, d_in) by its stacked (r, z, n) input
    kernels and (rows, hidden) by its stacked recurrent kernels."""
    return ys.linear_flops(rows, d_in, 3 * hidden) + ys.linear_flops(rows, hidden, 3 * hidden)


def _is_gru_cell(module) -> bool:
    """A flax-layout GRU cell: stacked input kernels `w_i` (3H, d_in) and
    recurrent kernels `w_h` (3H, H)."""
    w_i, w_h = getattr(module, "w_i", None), getattr(module, "w_h", None)
    return (isinstance(w_i, nn.Parameter) and isinstance(w_h, nn.Parameter)
            and w_h.dim() == 2 and w_h.shape[0] == 3 * w_h.shape[1])


class FlopCounter(tr.FlopCounter):
    """harness/trace.py's counter (nn.Linear, nn.Conv1d) with nn.Conv2d and
    the GRU cell besides; a call whose parameters take gradients is counted
    apart, for a backward of twice its forward."""

    def _hook(self, module, inputs, output):
        if isinstance(module, nn.Conv2d):
            f = conv2d_flops(output.shape[0], module.in_channels, module.out_channels,
                             *module.kernel_size, *output.shape[-2:], module.groups)
            weight = module.weight
        elif _is_gru_cell(module):
            h = inputs[0]
            f = gru_cell_flops(h.numel() // h.shape[-1], module.w_i.shape[1], module.w_h.shape[1])
            weight = module.w_i
        else:
            super()._hook(module, inputs, output)
            return
        if torch.is_grad_enabled() and weight.requires_grad:
            self.forward_with_grad += f
        else:
            self.forward += f
