"""Hand-written CUDA kernels and their wrappers.

KERNELS lists every kernel of the port (kernel B in
f32 twice, its train and eval modes apart; kernel G's train-mode first pass,
and its pool pass twice, train and eval mode apart; kernel F's three routes,
the ladder at k = 0, the resonant ladder and the phaser, apart too);
``launches`` reads their launch counters."""

from audiobd_tpu_torch.ops import conv1_bn_pool, conv2_bn_pool, effects, mfcc

KERNELS = (
    mfcc.MFCC_FFT_KERNEL,
    mfcc.MFCC_BLUESTEIN_KERNEL,
    mfcc.MFCC_LARGE_KERNEL,
    mfcc.MFCC_DEVICE_KERNEL,
    mfcc.MFCC_CLUSTER_KERNEL,
    conv1_bn_pool.BWD_PARAMS_KERNEL,
    conv1_bn_pool.BWD_PARAMS_EVAL_KERNEL,
    conv1_bn_pool.BWD_INPUT_KERNEL,
    conv1_bn_pool.FWD_RELU_KERNEL,
    conv1_bn_pool.FWD_KERNEL,
    conv1_bn_pool.FWD_EVAL_KERNEL,
    conv2_bn_pool.BWD_PARAMS_KERNEL,
    conv2_bn_pool.BWD_INPUT_KERNEL,
    conv1_bn_pool.BWD_PARAMS_BF16_KERNEL,
    conv1_bn_pool.BWD_INPUT_BF16_KERNEL,
    conv2_bn_pool.BWD_PARAMS_BF16_KERNEL,
    conv2_bn_pool.BWD_INPUT_BF16_KERNEL,
    effects.LADDER_KERNEL,
    effects.LADDER_RESONANT_KERNEL,
    effects.PHASER_KERNEL,
)


def launches() -> dict[str, int]:
    """Each kernel's launches so far, by name, in KERNELS's order."""
    return {k.name: k.launches for k in KERNELS}
