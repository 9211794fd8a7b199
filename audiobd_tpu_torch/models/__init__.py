from audiobd_tpu_torch.models.zoo import AST, RNN, LargeCNN, LSTMWithAttention, ResNet, SmallCNN, SmallLSTM, build_model

__all__ = ["AST", "LSTMWithAttention", "LargeCNN", "RNN", "ResNet", "SmallCNN", "SmallLSTM", "build_model"]
