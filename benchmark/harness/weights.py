"""Weights from the seed, made on the device in two large draws.

The scales follow ``unidet3d_tpu_torch/weights.py::seeded_init_`` (the JAX
package's initialisers): conv kernels Kaiming-uniform over (K * Cin), the
1x1 identity branches LeCun-uniform, Dense weights normal with std
1 / sqrt(fan_in) and zero bias, norms one and zero, running statistics
(0, 1). The values come from one ``torch.rand`` and one ``torch.randn``
over every parameter at once, on a ``torch.Generator`` of the model's
device, so that set-up makes no weight on the host; the reference, given
the same seed and a model with the same parameter names, gets the same
values."""
from __future__ import annotations

import torch


@torch.no_grad()
def init_from_seed_(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    params = list(model.named_parameters())
    device = params[0][1].device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(p.numel() for _, p in params)
    uniform = torch.rand(total, generator=gen, device=device).mul_(2).sub_(1)
    normal = torch.randn(total, generator=gen, device=device)
    at = 0
    for name, p in params:
        n = p.numel()
        leaf = name.rsplit(".", 1)[-1]
        u, z = uniform[at:at + n].view(p.shape), normal[at:at + n].view(p.shape)
        at += n
        if p.dim() == 3:  # (K, Cin, Cout) conv kernel
            p.copy_(u * (6.0 / (p.shape[0] * p.shape[1])) ** 0.5 / 2.0 ** 0.5)
        elif leaf == "i_branch":
            p.copy_(u * (3.0 / p.shape[0]) ** 0.5)
        elif p.dim() == 2:  # Dense weight (out, in)
            p.copy_(z / p.shape[1] ** 0.5)
        elif leaf == "weight":  # norm scale
            p.fill_(1.0)
        else:  # biases
            p.zero_()
    for name, buf in model.named_buffers():
        if name.endswith("running_mean"):
            buf.zero_()
        elif name.endswith("running_var"):
            buf.fill_(1.0)
    return model
