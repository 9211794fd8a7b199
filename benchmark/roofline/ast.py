"""AST's products a clip (``benchmark/reference/ast.py``): the patch
embedding's convolution, and in each block qkv, q kᵀ, the probabilities
times v, the output projection, fc1 and fc2; the head. LayerNorm, softmax,
GELU, the residual adds, the loss and the optimizer, each under 1% of a
step's operations, are left out."""

from __future__ import annotations


def tokens(n_mels: int, input_tdim: int, patch: int, stride: int) -> tuple[int, int]:
    """(patches, patches + the cls and distillation tokens)."""
    grid = ((n_mels - patch) // stride + 1) * ((input_tdim - patch) // stride + 1)
    return grid, grid + 2


def macs(n_mels: int, widths: dict, num_classes: int) -> dict:
    """Multiply-adds a clip: {"embed", "blocks" (every block's projections
    and MLP), "attention" (every block's q kᵀ and probabilities · v), "head"}."""
    d, h, depth = widths["dim"], widths["mlp_dim"], widths["depth"]
    grid, t = tokens(n_mels, widths["input_tdim"], widths["patch"], widths["stride"])
    return {
        "embed": float(grid * widths["patch"] ** 2 * d),
        "blocks": float(depth * t * (3 * d * d + d * d + 2 * d * h)),
        "attention": float(depth * 2 * t * t * d),
        "head": float(d * num_classes),
    }


def clip_flops(n_mels: int, widths: dict, num_classes: int) -> dict:
    """A training clip's {"forward", "backward"} operations: the backward
    takes every layer's weight gradient and every input gradient but the
    patch embedding's (its input, the features, takes none)."""
    m = macs(n_mels, widths, num_classes)
    fwd = 2.0 * sum(m.values())
    return {"forward": fwd, "backward": 2.0 * fwd - 2.0 * m["embed"]}
