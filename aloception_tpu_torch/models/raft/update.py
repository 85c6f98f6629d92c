"""RAFT's recurrent update block (counterpart of
``aloception_tpu/models/raft/update.py``), NCHW.

Motion encoder (correlation and flow convs) -> GRU (separable 1x5 / 5x1
gates, or 3x3 for RAFT-small) -> flow head, and for the standard model the
convex-upsampling mask head. Each conv runs in its weights' dtype and casts
its input to it, as a flax ``Conv(dtype=...)`` does; the GRUs cast their
gates' inputs once, before concatenating them (the same values: a cast is
element-wise). The GRU's hidden state stays in the dtype it comes in
(float32 in RAFT). Module names are the reference ``state_dict``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """A conv that casts its input to its weights' dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class FlowHead(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int = 256, device=None):
        super().__init__()
        self.conv1 = Conv2d(input_dim, hidden_dim, 3, padding=1, device=device)
        self.conv2 = Conv2d(hidden_dim, 2, 3, padding=1, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class SepConvGRU(nn.Module):
    """A horizontal (1x5) then a vertical (5x1) GRU pass, each with z, r and
    q gates over [h, x]."""

    def __init__(self, hidden_dim: int, input_dim: int, device=None):
        super().__init__()
        for i, (k, pad) in enumerate((((1, 5), (0, 2)), ((5, 1), (2, 0))), 1):
            for gate in ("z", "r", "q"):
                setattr(self, f"conv{gate}{i}",
                        Conv2d(hidden_dim + input_dim, hidden_dim, k,
                               padding=pad, device=device))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dtype = self.convz1.weight.dtype
        x = x.to(dtype)
        for i in (1, 2):
            hx = torch.cat([h.to(dtype), x], 1)
            z = torch.sigmoid(getattr(self, f"convz{i}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{i}")(hx))
            q = torch.tanh(getattr(self, f"convq{i}")(
                torch.cat([(r * h).to(dtype), x], 1)))
            h = (1 - z) * h + z * q
        return h


class ConvGRU(nn.Module):
    """The 3x3 GRU of RAFT-small."""

    def __init__(self, hidden_dim: int, input_dim: int, device=None):
        super().__init__()
        for gate in ("z", "r", "q"):
            setattr(self, f"conv{gate}", Conv2d(hidden_dim + input_dim,
                                                hidden_dim, 3, padding=1,
                                                device=device))

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        dtype = self.convz.weight.dtype
        x = x.to(dtype)
        hx = torch.cat([h.to(dtype), x], 1)
        z = torch.sigmoid(self.convz(hx))
        r = torch.sigmoid(self.convr(hx))
        q = torch.tanh(self.convq(torch.cat([(r * h).to(dtype), x], 1)))
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """(flow, corr) -> 128 channels: 126 of features, then the flow."""

    out_dim = 128

    def __init__(self, corr_channels: int, device=None):
        super().__init__()
        self.convc1 = Conv2d(corr_channels, 256, 1, device=device)
        self.convc2 = Conv2d(256, 192, 3, padding=1, device=device)
        self.convf1 = Conv2d(2, 128, 7, padding=3, device=device)
        self.convf2 = Conv2d(128, 64, 3, padding=1, device=device)
        self.conv = Conv2d(64 + 192, 128 - 2, 3, padding=1, device=device)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc2(F.relu(self.convc1(corr))))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)


class SmallMotionEncoder(nn.Module):
    """(flow, corr) -> 82 channels: 80 of features, then the flow."""

    out_dim = 82

    def __init__(self, corr_channels: int, device=None):
        super().__init__()
        self.convc1 = Conv2d(corr_channels, 96, 1, device=device)
        self.convf1 = Conv2d(2, 64, 7, padding=3, device=device)
        self.convf2 = Conv2d(64, 32, 3, padding=1, device=device)
        self.conv = Conv2d(96 + 32, 80, 3, padding=1, device=device)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        c = F.relu(self.convc1(corr))
        f = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([c, f], 1)))
        return torch.cat([out, flow], 1)


class BasicUpdateBlock(nn.Module):
    """(net, inp, corr, flow) -> (net, 0.25 * mask or None, delta_flow). The
    mask (64 * 9 channels, tap-outer) feeds the convex upsampling only, never
    the recurrence, so ``with_mask=False`` skips its head."""

    def __init__(self, corr_channels: int, hidden_dim: int = 128,
                 context_dim: int = 128, device=None):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, device)
        self.gru = SepConvGRU(hidden_dim, context_dim
                              + BasicMotionEncoder.out_dim, device)
        self.flow_head = FlowHead(hidden_dim, 256, device)
        self.mask = nn.Sequential(
            Conv2d(hidden_dim, 256, 3, padding=1, device=device),
            nn.ReLU(),
            Conv2d(256, 64 * 9, 1, device=device))

    def forward(self, net, inp, corr, flow, with_mask: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        delta_flow = self.flow_head(net)
        if not with_mask:
            return net, None, delta_flow
        return net, 0.25 * self.mask(net), delta_flow


class SmallUpdateBlock(nn.Module):
    """RAFT-small's block: no mask head (its flow is upsampled bilinearly);
    ``with_mask`` is taken for the interface and changes nothing."""

    def __init__(self, corr_channels: int, hidden_dim: int = 96,
                 context_dim: int = 64, device=None):
        super().__init__()
        self.encoder = SmallMotionEncoder(corr_channels, device)
        self.gru = ConvGRU(hidden_dim, context_dim
                           + SmallMotionEncoder.out_dim, device)
        self.flow_head = FlowHead(hidden_dim, 128, device)

    def forward(self, net, inp, corr, flow, with_mask: bool = True
                ) -> Tuple[torch.Tensor, None, torch.Tensor]:
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        return net, None, self.flow_head(net)
