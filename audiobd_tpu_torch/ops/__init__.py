"""Hand-written CUDA kernels and their wrappers.

KERNELS lists every kernel of the port with its launch counter."""

from audiobd_tpu_torch.ops.conv1_bn_pool import BWD_INPUT_KERNEL, BWD_PARAMS_KERNEL
from audiobd_tpu_torch.ops.mfcc import MFCC_KERNEL

KERNELS = (MFCC_KERNEL, BWD_PARAMS_KERNEL, BWD_INPUT_KERNEL)
