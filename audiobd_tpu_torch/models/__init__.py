from audiobd_tpu_torch.models.zoo import RNN, LargeCNN, LSTMWithAttention, ResNet, SmallCNN, SmallLSTM, build_model

__all__ = ["LSTMWithAttention", "LargeCNN", "RNN", "ResNet", "SmallCNN", "SmallLSTM", "build_model"]
