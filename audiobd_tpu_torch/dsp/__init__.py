from audiobd_tpu_torch.dsp.mfcc import MFCCParams, mfcc, mfcc_features

__all__ = ["MFCCParams", "mfcc", "mfcc_features"]
