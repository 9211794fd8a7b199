from audiobd_tpu_torch.models.zoo import SmallCNN, SmallLSTM, build_model

__all__ = ["SmallCNN", "SmallLSTM", "build_model"]
