from audiobd_tpu_torch.dsp.mfcc import MFCCParams, mfcc, mfcc_features
from audiobd_tpu_torch.dsp.resample import resample

__all__ = ["MFCCParams", "mfcc", "mfcc_features", "resample"]
