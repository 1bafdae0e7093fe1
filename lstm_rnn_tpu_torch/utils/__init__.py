from lstm_rnn_tpu_torch.utils.device import select_device  # noqa: F401
