"""SmallCNN's products a clip: three blocks of a 2x2 valid convolution, relu,
BatchNorm and max-pool, then two dense layers. BatchNorm, relu, pooling,
dropout, the loss and the optimizer, each under 2% of a step's operations,
are left out."""

from __future__ import annotations

# (input channels, output channels, pool, pool padding) of each block.
BLOCKS = ((1, 64, (1, 3), (0, 0)), (64, 64, (2, 2), (1, 1)), (64, 32, (2, 2), (0, 1)))


def pooled(h: int, w: int, pool: tuple[int, int], pad: tuple[int, int]) -> tuple[int, int]:
    return (h + 2 * pad[0] - pool[0]) // pool[0] + 1, (w + 2 * pad[1] - pool[1]) // pool[1] + 1


def macs(frames: int, n_mfcc: int, num_classes: int) -> tuple[list[float], int]:
    """(multiply-adds a clip of each product layer in order: conv1-3, fc1,
    fc2; the flatten size)."""
    h, w = frames, n_mfcc
    out = []
    c_out = 1
    for c_in, c_out, pool, pad in BLOCKS:
        h, w = h - 1, w - 1
        out.append(float(c_out * h * w * c_in * 4))
        h, w = pooled(h, w, pool, pad)
    flat = c_out * h * w
    out += [float(flat * 128), float(128 * num_classes)]
    return out, flat


def clip_flops(frames: int, n_mfcc: int, num_classes: int, train: bool, input_grad: bool) -> dict:
    """A clip's {"forward", "backward"} operations. ``train``: the weight
    gradients of every layer and the input gradients of all but the first;
    otherwise (a frozen model) ``input_grad`` asks for the input gradients of
    every layer, down to the first's input."""
    m, _ = macs(frames, n_mfcc, num_classes)
    fwd = 2.0 * sum(m)
    if train:
        bwd = 2.0 * sum(m) + 2.0 * sum(m[1:])
    else:
        bwd = 2.0 * sum(m) if input_grad else 0.0
    return {"forward": fwd, "backward": bwd}


def block1_shapes(batch: int, frames: int, n_mfcc: int) -> tuple[int, int]:
    """(elements of block 1's input x, of its pooled output's gradient g)."""
    h, w = pooled(frames - 1, n_mfcc - 1, *BLOCKS[0][2:])
    return batch * frames * n_mfcc, batch * BLOCKS[0][1] * h * w
