"""MobileNetV2 pointwise (1×1) layer inventory — paper §III-A workload.

The paper evaluates every PW layer of MobileNetV2 (ImageNet, 224×224) with
75 % global-L1 weight pruning.  A 1×1 convolution over a (H, W, Cin) tensor
is exactly the GEMM (M=H·W, K=Cin) × (K, N=Cout).

Activation sparsity: expand PW layers consume the *linear bottleneck* output
(no ReLU) → dense inputs; project PW layers and the final 1×1280 conv consume
ReLU6 outputs → sparse inputs.  Without ImageNet in this container the
post-ReLU6 sparsity is synthesised per layer (default 45 %, the
commonly-reported MobileNetV2 mid-network range); this is recorded in
EXPERIMENTS.md as a deviation.
"""
from __future__ import annotations

import dataclasses
from typing import List

# (expansion t, out channels c, repeats n, stride s) — Sandler et al., Table 2
_IR_BLOCKS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


@dataclasses.dataclass
class PwLayer:
    name: str
    m: int            # H_out * W_out
    k: int            # Cin
    n: int            # Cout
    input_relu: bool  # True -> input follows ReLU6 (sparse activations)

    @property
    def gemm_macs(self) -> int:
        return self.m * self.k * self.n


def pw_layers(input_size: int = 224) -> List[PwLayer]:
    layers: List[PwLayer] = []
    h = input_size // 2          # first 3x3 s2 conv -> 112
    cin = 32
    idx = 0
    for t, c, reps, s in _IR_BLOCKS:
        for r in range(reps):
            stride = s if r == 0 else 1
            h_out = h // stride
            if t != 1:
                # expand PW runs at the *input* resolution, dense input
                layers.append(PwLayer(f"pw{idx}_expand", h * h, cin,
                                      cin * t, input_relu=False))
            # project PW runs at the output resolution, post-ReLU6 input
            layers.append(PwLayer(f"pw{idx}_project", h_out * h_out,
                                  cin * t, c, input_relu=True))
            cin, h = c, h_out
            idx += 1
    layers.append(PwLayer("pw_head_1280", h * h, cin, 1280, input_relu=True))
    return layers
