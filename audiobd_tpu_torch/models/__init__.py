from audiobd_tpu_torch.models.zoo import SmallCNN, build_model

__all__ = ["SmallCNN", "build_model"]
